"""Chip smoke test of the PyTorch port (``mxtpu_torch``) on one NVIDIA H100.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. build   -- compile the flash-attention kernels
   (``mxtpu_torch/ops/csrc/flash_fwd.cu`` and ``flash_bwd.cu``, one nvcc
   each, started together) for sm_90a; prints each build's seconds, the
   compiler's register and spill lines and its notes of a performance
   loss (``kernel_build.ptxas_summary``).
2. kernel  -- hold each kernel against its plain PyTorch version on the
   card at the served and trained shape (64, 1024, 128) bf16 causal,
   and in f32 and bf16 at (6, 384, 64) causal and not, at the ragged
   (2, 100, 32) x (2, 90, 32) causal and not, at (3, 130, 16) causal,
   at d = 128 with partial 128-row tiles: (4, 1000, 128) causal and
   (2, 200, 128) x (2, 330, 128) not, and where a whole 64-row
   warpgroup of the backward's last block lies past the end:
   (3, 130, 128) causal and (2, 200, 64) x (2, 330, 64) not; then bf16
   (6, 384, 64) causal with a negative scale.  Forward, with and without the
   LSE: f32 rtol 2e-4 / atol 2e-5, the bounds
   tests/test_pallas_attention.py holds the TPU kernel to; bf16 one ulp
   of a probability plus one of the output, atol 2e-3 / rtol 2^-6 of
   ``error_scale``, a relative L2 error of at most 1e-2, and that file's
   0.05 (alone too loose: a typical output at the served shape is about
   that size).  Backward (dq from ``flash_bwd_dq``, dk and dv from
   ``flash_bwd_dkv``, with a random cotangent): f32 rtol 2e-3 / atol
   2e-4, that file's multiblock gradient bounds; bf16 atol 2e-3 / rtol
   2^-6 of the sum before it cancels (``bwd_error_scales``) and a
   relative L2 error of at most 1e-2 on each gradient.  Prints each
   kernel's time as a CUDA-event loop around its wrapper (``ms``) and as
   the card's busy time under torch.profiler (``device_ms``, which a slow
   host does not inflate), the plain versions' times, the least time the
   card could take (bound), and at the served shape
   ``torch.nn.functional.scaled_dot_product_attention``'s forward, and
   its backward, as yardsticks the port never calls (device time), with
   the forward's ratio to SDPA's on device time.
3. serve   -- the full-width TransformerLM (vocab 8192, d_model 1024,
   8 heads, 8 layers, d_ff 4096, T 1024, bf16; random weights from seed
   0) hosted in ``mxtpu_torch.serve.Server`` as a next-token server
   (tokens int32 [b, 1024] -> last-position logits float32 [b, 8192]),
   answering 1200 requests of 1-3 rows from 8 closed-loop clients,
   then three requests one at a time.  Checks every answer's shape and
   finiteness, that the kernel launched 8 times per dispatch, and one
   row against the port's forward on the CPU (plain path, the same
   weights in float32).  Prints the clients' request latency p50/p99
   over all 1200 requests, the tokens per second served, and the
   forward's device time by bucket and by block.  The backward kernels
   must not launch.
4. train   -- the same model trained as bench.py's transformer row: the
   config above with ``remat="dots"``, Adam at lr 1e-3, K = 8 steps a
   fused call (``make_fused_train_steps``), tokens and labels drawn from
   ``np.random.RandomState(0)``.  One warm call and 3 timed calls on
   the same stacks.  Checks that every loss is finite, that the last is
   below the first, and that each kernel launched exactly its count
   per step (``PER_STEP``) times the 32 steps.  Then one step at batch
   1 and 2 layers against the port's step on the CPU in float32 (loss
   and every gradient).  Prints tokens/s and ms per step (host clock,
   synchronised by value), the device time of one step's forward and
   loss, backward and update (CUDA events), the attention backward's
   share of the backward, peak device memory, and one step's kernels
   under torch.profiler (device busy time, idle share, the kernels with
   the most device time).

5. resnet  -- ResNet-50 v1 trained through ``mxtpu_torch.sym`` and
   ``mxtpu_torch.mod`` as bench.py's per-step row does
   (``run_per_step_fp32``): the graph traced by the port's gluon
   (``sym.ZOO["resnet50_v1"]()``, equal to the JAX package's trace), a
   ``Module`` bound on the card at data (32, 3, 224,
   224) and label (32,), ``Xavier`` after ``random.seed(0)``, SGD with
   lr 0.01 and momentum 0.9, one fixed batch drawn as bench.py draws it;
   2 warm steps and 20 timed steps of forward/backward/update in fp32
   (TF32 off), synchronised by value.  Checks that the outputs are
   finite, that the cross-entropy of the last step is below the first's,
   that every BN moving stat (running_mean, running_var) moved and every
   moving variance stays positive, that no flash-attention kernel
   launched, and one step at batch 2 on the card against the same step
   on the CPU and in float64 (the output's relative L2 against the CPU's
   at most 1e-4; all updates as close to the float64 step as the CPU's
   float32 step is, within a factor 2, each parameter's within a factor
   3: ``resnet_step_check``; the same step with TF32 on is printed
   beside it).  Prints images/s and ms a step as
   ``resnet50_train_imgs_per_sec_bs32_per_step``, one profiled step
   (device busy time, idle share, launches, the 8 device operations with
   the most time), peak device memory and the step's fp32 bound.
6. fused   -- bench.py's fused ResNet rows (``run_config``): the same
   network and optimizer in ``mxtpu_torch.FusedTrainLoop``, K = 16 steps
   a call as replays of one CUDA graph of the step, on one stack of 16
   batches drawn on the card: ``resnet50_train_imgs_per_sec_bs32`` (fp32,
   TF32 off, batch 32), ``bf16_bs32_imgs_per_sec`` and
   ``bf16_bs128_imgs_per_sec`` (bound under ``amp.scope("bfloat16")``),
   each after freeing the one before.  First, K = 4 fused steps from one
   state against 4 per-step steps (SGD momentum 0.9, the rate halving
   every step), twice: from a new loop, and again after
   ``init_optimizer(force_init=True)`` replaced the optimizer and its
   states (the loop must capture again); the weights, the momenta and
   the moving stats, each group on its own, within twice the group's
   distance between two per-step runs from that state; and under
   cuDNN's deterministic algorithms bitwise equal to the per-step
   steps.  And a graph
   with a random op must draw anew on every replay.  Each row: 2 warm
   and 4 timed calls (bench.py runs 3 windows of 8) collecting no
   outputs, as bench.py's loop, synchronised by value, then a profiled
   call, and a first and a last call that collect them; checks that
   the collected outputs are finite, that the cross-entropy of the last
   call is below the first's, that every moving stat moved and every
   moving variance is positive, that no flash-attention kernel
   launched, that cuDNN ran bf16 convolutions under bf16 and none in
   fp32, and under bf16 that the parameters and states stay float32 and
   that the first step's logits lie from the fp32 forward's from the
   same state between ``BF16_LOGIT_FLOOR`` and ``BF16_LOGIT_CEIL``
   (relative L2).  Prints ms a step, images/s under bench.py's row
   name, mfu against the card's peak for the dtype (67 TFLOP/s fp32,
   989 bf16), set-up and capture seconds, peak memory (allocated, and
   reserved with the graph's pool), and from one profiled call the
   device busy time, idle share, device operations and host launches a
   step and the top 8 operations.
7. gluon   -- the same network trained through ``mxtpu_torch.gluon`` as
   README.md's first example: ``model_zoo.vision.resnet50_v1`` built in
   a fresh NameManager, ``Xavier`` after ``random.seed(0)``,
   ``hybridize()``, the loss (``SoftmaxCrossEntropyLoss``) under
   ``autograd.record()``, ``backward`` and ``Trainer("sgd", lr 0.01,
   momentum 0.9, kvstore="device").step(32)`` on bench.py's batch 32
   (fp32 with TF32 off, and traced inside ``amp.scope("bfloat16")`` as
   bench.py:118 does), 2 warm and 20 timed steps synchronised by value.
   Checks that the timed steps' mean losses are finite and the last is
   below the first, that every BN moving stat moved and every moving
   variance is positive, that no flash-attention kernel launched, and
   that cuDNN ran bf16 convolutions under bf16 and none in fp32.
   Prints ms a step and images/s, one profiled step (device busy time,
   idle share, device operations, by kind, the top 8) and peak memory,
   each beside the resnet phase's Module row.  Then, from one state
   under cuDNN's deterministic algorithms, one Trainer step against one
   Module step over the traced graph (each of weights, momenta and
   moving stats within ``GLUON_MODULE_TOL``) and against the same step
   not hybridized (bitwise equal).  Then a HybridBlock calling
   ``F.contrib.flash_attention`` at (8, 8, 1024, 128) bf16, causal and
   not, hybridized, under ``record()`` with ``backward``: exactly one
   launch of each kernel a call, the output and gradients against the
   plain versions at ``TOL``/``BWD_TOL`` and ``BF16_REL_L2``.
8. lm      -- BASELINE config #3, the LSTM language model, both ways.
   First the checks of the ops: ROADMAP C4 (raw ``nd.Convolution`` at
   ResNet's first layer, ``nd.FullyConnected`` at (1120, 650) x
   33,278 and ``nd.RNN`` at (35, 32, 650) x 2 LSTM layers, called after
   the process set both TF32 flags on, each against the same op in
   float64 within ``C4_TOL``, and beyond it with the ops' TF32 rule
   taken out); the fused ``RNN`` op (cuDNN, a call per layer) against
   its plain loop at (35, 32, 650) x 2 LSTM layers and a bidirectional
   2-layer GRU at (12, 4, 24) x 16: outputs, final states and the
   gradients with respect to data, parameters and states within
   ``RNN_OP_TOL``, and beyond it with TF32 on; its device time beside
   the plain loop's and ``torch.nn.LSTM``'s.  Then row
   ``word_lm_gluon``: examples/rnn/word_lm/train.py's model at the
   medium configuration (``WORD_LM``: vocabulary 33,278, 2 x 650 LSTM,
   tied decoder, dropout 0.5; bptt 35, batch 32, fp32), hybridized, on
   the example's Markov stream from seed 0: SGD lr 20, clip 0.25, the
   mean loss, states detached at every boundary; 2 warm and 20 timed
   steps synchronised by value (ms a step, tokens/s), the host's ms a
   step by stage (forward, loss, ``backward``, ``clip_global_norm``,
   ``Trainer.step``), one profiled step (busy, idle share, operations,
   by kind, the top 10), peak memory, one evaluation pass without
   ``record()``; the losses finite and falling (the mean of the last 5
   below the first 5's).  With dropout 0, one step at batch 2 against
   the port's CPU f32 step from the same weights (``LM_CPU_TOL``) and
   one at batch 32 not hybridized against hybridized
   (``LM_HYBRID_TOL``).  Then row ``lstm_bucketing``:
   example/rnn/bucketing/lstm_bucketing.py's defaults (``BUCKET_LM``: 2
   LSTMCell layers of 200 unrolled, embedding 200, vocabulary 10,000,
   batch 32, buckets 10-60, SGD lr 0.01, Xavier) as one epoch of
   ``BucketingModule.fit`` over 1300 synthetic sentences (every bucket 3
   batches or more), ``Perplexity(ignore_label=0)`` and a
   ``Speedometer``: ms a batch by bucket, positions and real tokens a
   second, one profiled step at bucket 60, peak memory; the perplexity
   over every label the SoftmaxOutput trains on must fall (the real
   tokens' is printed: on uniform synthetic tokens it cannot fall in
   one epoch at lr 0.01), 6 executors holding one tensor a parameter
   name and one optimizer, one step at bucket 10 against the CPU's
   (``LM_CPU_TOL``).  No flash-attention kernel may launch on either
   row.
9. sparse  -- BASELINE config #5, sparse linear classification, on
   ``examples/sparse/linear_classification.py`` itself (its imports of
   the JAX package turned into ``mxtpu_torch``: ``linear_example``).
   Its ``synthesize()`` writes 65,536 rows at the Avazu-app set's
   1,000,000 features (seed 0); one ``LibSVMIter`` at batch 8,192
   (CSR batches on the card) serves three rows of its loop, 2 epochs
   each: ``linear_cls_adagrad`` (AdaGrad lr 0.1, an Updater),
   ``linear_cls_sgd`` (SGD lr 819.2, an Updater) and
   ``linear_cls_kvlocal`` (AdaGrad on ``kv.create("local")``:
   ``row_sparse_pull`` of the batch's columns, rows-only pushes).  Each
   prints ms a batch, examples/s and nnz/s (host clock), the host's
   split (the batch made on the host, its copy to the card, pull,
   forward and loss, ``backward``, update or push), a profiled batch
   (busy, idle share, operations, by kind), its host syncs (torch's
   sync debug mode), peak memory, a bound (the CSR batch and the
   touched rows read and written once at 3.35 TB/s), the mean loss by
   epoch (finite and falling, or the run fails) and the training
   accuracy (printed only).  Then: one AdaGrad step on the card
   against the port's CPU step (``SPARSE_CPU_TOL``; every untouched
   row and its history bitwise as before, with wd 0 and 1e-4); the
   sparse products and the row-sparse gradient on 512 rows against the
   densified product with TF32 off (``SPARSE_DOT_TOL``); the example's
   ``main()`` at 50,000 features, 1,500 rows, 2 epochs, with and
   without the local store (at least 0.9 accuracy); two row-sparse
   pushes against their dense sum and ``row_sparse_pull`` into both
   kinds of output; ``embedding_sparse`` and ``embedding_dense``
   (``gluon.nn.Embedding(1,000,000, 32)``, ``Trainer`` SGD lr 0.1, 512
   ids a step: ms a step, busy, operations, syncs, peak memory) and one
   sparse step against one dense step (``EMBED_TOL``).  No
   flash-attention kernel may launch on any row.
10. dist   -- BASELINE config #5's distributed half: the same example's
   ``main()`` (``--synthesize``, 65,536 rows, 1,000,000 features, batch
   8,192, ``DIST_EPOCHS`` epochs over each worker's half, AdaGrad lr
   0.1, on the sparse phase's file) as the two workers of the port's
   launcher, ``mxtpu_torch/tools/launch.py -n 2 -s 1`` (``LAUNCHER``;
   this script in its ``--dist-worker`` mode; both workers on the one
   card, the scheduler and the server CPU processes), once with
   ``--kvstore dist_async`` (``linear_cls_dist_async``) and once with
   ``dist_sync`` (``linear_cls_dist_sync``).  Each worker prints ms a
   batch and examples/s (host clock, the mean over all epochs but the
   first, with the least, the median and the most), its split
   (``row_sparse_pull`` and the bias pull, the step on the card, the
   pushes), the bytes it sent and received a batch (its
   parameter-server frames, counted by wrapping
   ``_ps._send_msg``/``_recv_msg`` here), and its ``FINAL_ACCURACY``,
   which must reach ``DIST_MIN_ACCURACY`` (the example's
   ``--min-accuracy``).  The server's ops, the waits for its lock and
   its AdaGrad are timed in its own process (``SERVER_HOOK``, loaded
   there as ``sitecustomize``).  Checks: once both workers are done,
   the server's version of each key (the updates it applied) is the
   number of pushes (``dist_async``) or rounds (``dist_sync``); a
   weight push's bytes are those of the batch's unique rows (24 bytes a
   row: two floats and a span), not of 1,000,000; under ``dist_sync``
   the two workers' final weights are bitwise equal and within
   ``DIST_REPLAY_TOL`` (relative L2) of a replay on the card in this
   process: the same lazy AdaGrad applied, round by round, to the sum
   of the two shards' row-sparse gradients.  The kernels' launches are
   counted in the workers and in the replay.
11. mnist  -- BASELINE config #1,
   ``examples/image-classification/train_mnist.py --network lenet
   --dummy`` (its imports renamed, ``mx.tpu()``/``num_tpus()`` made
   ``mx.gpu()``/``num_gpus()``: ``mnist_example``): 6,000 synthetic
   examples, batch 64, 2 epochs (its default 3) of ``Module.fit``, SGD
   lr 0.1 momentum 0.9, on the card from ``mx.random.seed(0)``:
   first ``MNIST_CPU_STEPS`` Module steps on the card against the CPU
   (``MNIST_CPU_TOL``), then ``mnist_lenet_local`` in this process and
   ``mnist_lenet_dist_sync`` as two launched workers
   (``--mnist-worker``) with one server.  Prints ms a batch and
   images/s (host clock, the last epoch) and the validation accuracy
   (random labels: about 0.1).  Under ``dist_sync`` the two workers'
   final parameters must be bitwise equal, the server must have applied
   one update of each key a batch, rank 0 must start from the local
   run's parameters, and the final parameters must lie within
   ``MNIST_DIST_TOL`` of the local run's movement from its final ones:
   both workers see the same batches, so a round's summed gradient at
   half the rescale is the local step's.  No flash-attention kernel may
   launch in either phase (counted in the workers too).
12. ops    -- every canonical op the port registers (313; the cases of
   ``tests/test_torch_op_cases.py``: numpy inputs from fixed seeds, with
   the ties of max/min/sort/argsort/topk, clip's bounds, rounding at .5
   and mod with mixed signs) on the card against the same call on the
   CPU, and the gradients of a random-weighted sum: float32 within
   ``OPS_RTOL`` of the CPU's value plus ``OPS_ATOL`` of the output's
   largest magnitude (gamma, gammaln, erfinv, CTCLoss and the flash kernels
   ``OPS_SPECIAL``, the products with TF32 off ``OPS_PRODUCT_RTOL`` and
   ``OPS_PRODUCT_ATOL``), integer and
   ordering results equal; the samplers and Dropout in training by
   moments, BlockGrad by its gradient.  Prints the count of ops, the
   largest error as a fraction of its bound and its op, and the largest
   relative L2 of a floating result and its op.  (``c4_check``, in the
   lm phase, holds the new products ``dot``, ``batch_dot``, ``einsum``
   and ``_onnx_MatMul`` to float64 with TF32 set on.)
13. zoo    -- BASELINE config #2 on MobileNet v2: the script
   ``examples/gluon/image_classification.py`` itself (imports renamed,
   ``mx.tpu()``/``num_tpus()`` made ``mx.gpu()``/``num_gpus()``:
   ``zoo_example``) with ``--model mobilenet_v2_1_0 --classes 1000
   --batch-size 32 --image-shape 3,224,224`` and its own settings
   (hybridized, SoftmaxCrossEntropyLoss, Trainer SGD lr 0.05 momentum
   0.9, fp32 with TF32 off; 10 batches of fresh random images); then
   the row ``mobilenet_v2_gluon``, the same net and settings on one
   fixed batch, 2 warm and 20 timed steps: ms a step, images/s, busy,
   idle share and operations of a profiled step, time by kind
   (``ZOO_KINDS``, depthwise convolutions apart), peak memory, the
   host's split (forward, loss, ``backward``, ``Trainer.step``); the
   loss must fall and no flash kernel launch.  One batch-2 Trainer step
   on the card against the CPU from the same weights
   (``zoo_step_check``): in float64 the updates within ``ZOO_F64_TOL``;
   in float32 the loss and the moving stats within ``ZOO_CPU_TOL`` and
   the updates as ``resnet_step_check`` holds ResNet's (the step is
   ill-conditioned at batch 2): all together within 2x, each parameter
   within 3x the CPU's own distance from float64, the largest over
   three float32 runs on the CPU (``ZOO_CPU_RUNS``) and, per parameter,
   at least the CPU's relative distance for all updates; the same step
   with TF32 on must break that bound.
   Then each other family (``ZOO_FAMILIES``: mobilenet1_0,
   densenet121, inception_v3 at 299², squeezenet1_1, vgg16_bn,
   alexnet) at full width, Xavier, hybridized: a batch-8 forward, finite
   and (8, 1000), its ms, and batch 1 against the CPU within
   ``ZOO_CPU_TOL``.  Every line of numbers names the card.
14. imagenet -- BASELINE config #4's one-device half: the script
   ``examples/image-classification/train_imagenet.py`` itself, loaded
   into the port by ``tests/test_torch_example_port.py`` (its ``common``
   and ``symbols`` helpers' imports renamed, indented ones too), with
   ``IMAGENET_ARGS``: ResNet-50 v1, 1000 classes, 224², batch 128, a
   ``device`` store, NAG lr 0.1 momentum 0.9 wd 1e-4, MSRA, top-5,
   2 epochs of 20 batches of its synthetic data, fp32 with TF32 off.
   The row ``imagenet_resnet50_nag``: ms a step and images/s over the
   last epoch (each batch's end read after the metrics fetched its
   outputs), the host's split (forward, backward, update), the
   per-parameter updates a step, peak memory, busy, idle share and
   operations of one profiled step of the trained Module; the
   Speedometer's lines with top-5 must print, both epochs' checkpoints
   exist, the loss is finite and no flash kernel launches.  Then one
   NAG step of the net at batch 2 against the CPU, as
   ``resnet_step_check`` holds the SGD step (``STEP_RULES``).
15. optim  -- every registered optimizer (16) on ResNet-50 v1's tree
   (161 parameters, the gradients of one batch-8 backward on the card):
   three ``update_multi`` steps on the card and on the CPU from the
   same state with ``OPTIM_COMMON`` (wd, clip_gradient, rescale_grad),
   every weight and state within ``OPTIM_TOL``; SGD, NAG and Adam with
   ``multi_precision`` on bf16 weights (masters within ``OPTIM_TOL``,
   bf16 weights within one bf16 ulp); SGLD's noise within 5 standard
   errors of N(0, 3 lr); each prints its device busy ms (one profiled
   call) and its host ms an
   ``update_multi``.  A NAG Module restored by ``Module.load(...,
   load_optimizer_states=True)`` takes the next step bit for bit
   (cuDNN deterministic).
16. random -- every sampler (``MOMENTS``) draws 2^20 values on the card:
   mean and variance within 5 standard errors, a KS test (continuous)
   or a chi-squared test (discrete) against ``scipy.stats`` (p above
   1e-6); the multinomial's frequencies; ``_sample_unique_zipfian`` at
   (512, 256) of 10,000 classes unique in each row, its inclusion
   frequencies within 5 binomial standard errors of the CPU's;
   ``_shuffle`` a permutation; ``set_state(get_state())`` replaying
   each sampler bit for bit.  Then ``examples/rnn/large_word_lm/
   train.py`` at its defaults on the card (its context made the card's):
   the perplexity falls and ends under the JAX package's gate of 5000.
17. gan    -- the DCGAN of Radford et al. at its published widths
   (``tests/test_torch_dcgan_net.py``, as MXNet's
   example/gluon/dc_gan/dcgan.py builds it: nz 100, ngf = ndf = 64,
   64x64x3, both nets hybridized without biases, batch 128,
   ``SigmoidBinaryCrossEntropyLoss``, two Trainers with Adam lr 2e-4
   beta1 0.5, fp32 with TF32 off) on real images and noise drawn with
   numpy from ``GAN_SEED``: ``GAN_ITERS`` iterations, each a D step on a
   real and a fake batch and a G step.  The row ``gan_dcgan64``: ms an
   iteration and images/s past ``GAN_WARM`` (host clock, synchronised
   by value), the host's split (D, its update, G, its update), the
   bound of its convolutions' operations (``dcgan_flops``), busy,
   idle share and operations of one profiled iteration with the
   transposed convolutions' kernels apart (the generator's convolution
   kernels, its backward found by sequence number), peak memory; every
   loss finite, no flash kernel launched.  Then one iteration at batch
   ``GAN_CHECK_BATCH`` on the card against the CPU from the same
   weights, images and noise (gradients, weights, moving stats and
   losses within ``GAN_CPU_TOL``), and ``GAN_EXAMPLES`` on the card
   (``example_run``: imports renamed, the TPU and CPU contexts the
   card's), each to its end and its own assertions.
18. seq    -- ``CTCLoss`` at ``CTC_SHAPE`` (T 200, N 32, 29 classes
   with the blank), label lengths 20-80 and data lengths 150-200 from a
   seed, row 0 given fewer frames than labels, under both blank
   conventions with data and label lengths (``CTC_CASES``): the costs
   and the data's gradient on the card against the CPU
   (``CTC_TOL``) and the ms of forward and backward; ``ctc/ocr_ctc.py
   --epochs 8``, ``speech_recognition/speech_ctc.py --epochs 12`` (its
   loss falling, its ``FINAL_LER`` printed beside the gate of
   tests/test_examples.py, which is a draw of the initial weights:
   ``SPEECH_LER_GATE``; its loop from one draw on the card against the
   CPU, ``speech_check``) and ``svm_mnist/svm_mnist.py --epochs 3`` on
   the card; two ``gluon.rnn.LSTMCell``s
   unrolled at word_lm's widths (35, 32, 650) against
   ``gluon.rnn.LSTM(650, num_layers=2)`` on the same weights
   (``LSTM_CELL_TOL``); every linalg op at 16 matrices of 64x64 on the
   card against the CPU, outputs and gradients (``LINALG_TOL``; the
   factors of gelqf and syevd without their signs).  No flash kernel
   may launch on any row.
19. cflow  -- row ``cflow_foreach_lm``: the lm phase's word LM at its widths
   (``CFLOW_LM``: vocabulary 33,278, 2 LSTM layers of 650, bptt 35,
   batch 32, fp32 with TF32 off) written as a Symbol with one
   ``sym.contrib.foreach`` over the 35 steps whose body is the two
   layers' FullyConnected gates in the fused op's order (i, f, c, o),
   the decoder tied to the Embedding, ``SoftmaxOutput``
   (``tests/test_torch_foreach_lm_net.py``); through ``Module`` (SGD lr
   1 on the mean loss), 2 warm and 20 timed steps, then through
   ``FusedTrainLoop`` (K = 8, one CUDA graph): ms a step, tokens/s, busy,
   idle, operations a step, peak, losses finite.  One step from the
   same weights against the same model over the fused ``RNN`` op
   (``CFLOW_RNN_TOL``) and the captured loop's weights after 8 steps
   against 8 per-step steps (``CFLOW_LOOP_TOL``).  Then
   ``cflow_cases``, each on the card against the CPU
   (``CFLOW_CASE_TOL``): a ``while_loop`` at ``max_iterations`` 64 whose
   trip count depends on the data, ``cond`` with each branch taken
   (forward and gradient, the branch not taken none), a BatchNorm inside
   ``foreach`` whose moving stats reach the outer aux, a HybridBlock
   calling ``F.contrib.foreach`` hybridized and not, a graph with a
   ``cond`` and a ``while_loop`` trained in a captured FusedTrainLoop
   against per-step steps, a ``cond`` whose branch not taken has an
   infinite or NaN derivative (the square root and the log of values at
   and below 0) trained 4 steps in a captured FusedTrainLoop (both
   branches run) and per step on the card and the CPU (the branch taken
   only): every weight finite and equal to the CPU's
   (``cflow_singular_case``); a symbolic ``while_loop`` backward must
   raise, as in the JAX package.
20. data   -- row ``data_cifar_resnet18``: CIFAR-10's published binary
   format written from ``DATA_SEED`` into a temporary root (five files
   of 10,000 rows of 3,073 bytes, 153.65 MB), read by
   ``gluon.data.vision.CIFAR10``, ``transform_first(Compose([
   RandomFlipLeftRight(), ToTensor(), Normalize(...)]))``,
   ``DataLoader(batch_size=128, shuffle=True, last_batch="discard",
   num_workers=4)`` with threads, into ``resnet18_v1(classes=10)``
   hybridized under a Trainer (SGD lr 0.1, momentum 0.9, wd 5e-4, fp32
   with TF32 off): 60 iterations (5 warm) at ``MXTPU_PREFETCH_DEVICE``
   0 and 30 at 2, ms an iteration, images/s and the input-wait share
   (``telemetry.input_wait``); a profiled iteration (busy, idle,
   operations, by kind, peak, the bound from ``data_flops``); the loader
   alone over 100 batches at 0 workers, 4 threads and 4 processes over
   the same images as numpy.  Checks: the three worker modes' first
   three batches equal (flip left out), ``state()`` after batch 5 and
   ``set_state`` on a fresh loader give the same batches 6-8, the flip's
   rate over 200 draws, one iteration at batch 8 against the CPU
   (``DATA_CPU_TOL``), the losses finite.  No flash kernel may launch.
21. det    -- the detection ops.  Rows ``det_ssd_mini``
   (``examples/ssd/ssd_mini.py``, 8 epochs at ``--det-threshold 0.05``,
   ``DET_SSD_ARGS``: seconds an epoch, detections per image, its own
   assertion) and ``det_frcnn_mini`` (``examples/rcnn/faster_rcnn_mini.py``
   at its defaults, its ``mx.cpu()`` made the card's: FINAL_ROI_ACCURACY
   above 0.5, and the proposals, the pooled maps and the parameters on
   the card, read by wrapping ``nd.contrib.MultiProposal``,
   ``nd.ROIPooling`` and ``Trainer.step``); ``det_frcnn_vgg16``
   (``tests/test_torch_detection_net.py``: Faster R-CNN with the zoo's
   VGG16 to conv5_3 on one 600x1000 image, the RPN, ``MultiProposal``
   12,000 -> NMS 0.7 -> 2,000, 128 ROIs pooled 7x7, fc6 and fc7 4096, 21
   classes, random weights; 2 warm and 6 timed SGD steps through
   gluon's Trainer: ms a step, busy, idle, operations, peak, by kind;
   losses finite; then on the card against the CPU: the boxes before
   NMS (order and scores equal, coordinates within ``DET_BOX_TOL``), the
   NMS mask of the same boxes, the rois and the pooled features equal,
   and one step's gradients within ``DET_GRAD_TOL``, layer by layer
   from the loss down, each layer given the card's input and the card's
   gradient of its output on both devices, so that every ReLU and max
   decides alike); ``det_ssd300_heads`` (SSD300's ``MultiBoxPrior`` over its six
   maps, 8,732 anchors; ``MultiBoxTarget`` at batch 32 with 1-8 boxes an
   image; ``MultiBoxDetection`` at batch 8 over 21 classes, NMS 0.45: its
   decoding and its NMS on the card against the CPU's, the NMS over the
   same decoded boxes equal; its IoU held a tile of (8, 256, 8,732) at a
   time; host ms on the card and the CPU).  No flash kernel may launch.
22. quant  -- INT8 post-training quantization and the slice's other
   names.  Row ``quant_resnet50_int8``: ResNet-50 v1
   (``sym.ZOO["resnet50_v1"]``, He-normal weights from ``QUANT_SEED``)
   through ``contrib.quantization.quantize_model`` over 10 batches of 32
   synthetic 224² images, ``naive`` then ``entropy``, the first
   convolution excluded (MXNet's ``imagenet_gen_qsym.py`` defaults);
   the int8, fp32 (TF32 off) and bf16 graphs at batch 64: ms a batch,
   images/s, busy, idle, operations, peak; the int8 GEMMs a forward
   (``ops.quantization.INT8_LAUNCHES``: one ``torch._int_mm`` per
   quantized node); every quantized convolution and FC fed the card's
   own int8 input, its int32 accumulator equal to the float64 plain
   version (``quant_layer_check``), and the excluded first convolution
   (K = 147) quantized alike; the softmax against fp32 and the count of
   quantized nodes printed, not gated.  Row ``quant_convbn_fold``:
   ``optimize_for("TPU", args, aux)``, every BatchNorm folded, the
   logits within ``QUANT_FOLD_TOL`` of the unfolded graph's, both timed.
   Rows ``quant_example`` (``examples/quantization/quantize_model.py``
   in both calibration modes, its assertion; every executor's arrays on
   the card) and ``custom_softmax`` (``examples/numpy-ops/
   custom_softmax.py --epochs 5``, its assertion, ms a batch; a
   FusedTrainLoop of K = 4 over the same network never captured and
   within ``CUSTOM_LOOP_TOL`` of 4 per-step steps).  Row
   ``dgl_sample_pubmed``: a graph of Pubmed's size from a seed (19,717
   vertices, 44,338 undirected edges both ways, dense (V, V) float32),
   both neighbor samplers at 1,000 seeds, 2 hops of 10, at most 8,192
   vertices: ms a call, peak, every hop-h vertex reached from hop h-1,
   at most 10 new a frontier vertex, the induced subgraph equal to the
   CPU's, and the sampler fed the card's draws equal to the CPU's.  No
   flash kernel may launch.
23. a10c   -- A10c's leftovers.  Row ``ctx_engine``: ``with mx.gpu(0):``
   and ``with mx.cpu():`` (nested) placing arrays, a gluon
   ``initialize()`` and a Module bind; a 256 MB ``cpu_pinned`` array
   (``is_pinned()``, its ``non_blocking`` copy to the card equal, timed
   beside a pageable one) and a ``cpu_shared`` one; the threaded engine
   built from ``src/engine.cc`` on this host, an error pushed on it
   raised at the wait; ``model.FeedForward`` fitting LeNet for one epoch
   of 6,000 synthetic MNIST images on the card, its ``predict`` against
   a Module's on the same parameters (relative L2 1e-6).  Row
   ``imagenet_monitor``: ``train_imagenet.py`` with the imagenet
   phase's arguments and ``--monitor 10 --max-batches 30 --num-epochs
   1``: the Monitor must print at batches 0, 10 and 20, each value
   within ``A10C_MONITOR_TOL`` of |x|'s mean recomputed in float64 from
   the same executor outputs; ms a step of the monitored batches and of
   the others.  Rows ``resnet50_nhwc_fp32`` and ``resnet50_nhwc_bf16``:
   the resnet phase's graph channels-last (``resnet50_nhwc``: layout
   NHWC on every Convolution and Pooling, BatchNorm on axis 3, one
   transpose at the input) and the NCHW graph, each through Module at
   batch 128, 224², fp32 with TF32 off or bf16 through ``amp``, SGD
   momentum 0.9, fed from the host by a ``PrefetchingIter`` on the
   engine: ms a step, busy, idle, operations, device ms by kind and the
   layout-copy kernels of a step (``LAYOUT_COPY_KEYS``), side by side;
   then ``nhwc_step_check`` at batch 8: the float64 step of both graphs
   from the same weights within ``NHWC_LAYOUT_TOL``, and the float32
   step layer by layer (``nhwc_layers``) within ``RESNET_OUT_TOL``.
   Row ``ragged_serve``: ResNet-50 bound for inference at batch 128
   under the pow2 bucket policy: a cold first call, ``warmup`` and the
   first call after it, then batches of 1, 37, 64, 100 and 128, each
   against an exact forward of that batch (``RAGGED_TOL``), with no
   bind while serving.  No flash kernel may launch.
24. spmd   -- the SPMD half of several devices, every shard on this one
   card (meshes that repeat ``cuda:0``: one controller drives every
   shard, and its cross-device copies are same-device copies, so no
   interconnect is measured).  Rows ``spmd_ring_sp2_causal`` and the
   other three of sp 2 and 4, causal and not: global (B 8, H 8, T 1024,
   D 128) bf16 split over the sequence, ``ring_attention`` on the
   shards (the forward kernel with the LSE per kept block, merged in
   f32; ``flash_bwd_dq``/``flash_bwd_dkv`` per kept pair with the
   global LSE and delta) against the plain ring on the card and against
   the unsharded ``flash_attention``, output and dq/dk/dv within
   ``RING_TOL`` (tests/test_pallas_attention.py's bf16 bound) and a
   relative L2 of ``BF16_REL_L2``; a causal call launches each kernel
   sp(sp+1)/2 times, the other sp^2.  Each kernel is timed at the
   sharded step's block shape (mb * H / tp, T / sp, 128) = (8, 512,
   128).  Row ``spmd_step``: the train phase's model (``MODEL``,
   ``remat="dots"``) at batch 8 on the mesh ``SPMD_AXES`` (dp 2, pp 2,
   tp 2, sp 2: 16 shards), two microbatches, ZeRO-1 Adam at lr 1e-3,
   3 steps on one batch; step 1 against the one-device step from the
   same weights (loss, first moments, parameters: ``spmd_step_check``),
   each device's moments 1/dp of its shard's (where ZeRO-1 splits
   them), launches a step exact (``spmd_launches``), losses finite and
   falling; ms a step, busy and idle share of a profiled step, peak
   memory.  Row ``spmd_transformer_lm``:
   ``examples/transformer_lm/train.py`` at its defaults (dp 2, tp 2,
   sp 2, 60 steps) through ``tests/test_torch_example_port.py``'s
   loader over ``[cuda:0] * 8``: it must print CONVERGED.  Row
   ``spmd_microbench``: ``parallel.collectives.microbench`` (16 MB over
   {dp 2, tp 4}), every collective's result checked.

The line before the last is the card's name and power limit, the line
before that the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero and prints no result.

Options (none by default): ``--parent DIR`` runs only the sparse and
lm phases of the checkout DIR (such as the parent commit unpacked by
``git archive``) and of this one, in turns (DIR, this, this, DIR), each
in a process of its own, and prints each row's ms, busy ms, device
operations and syncs side by side; ``--baseline DIR`` also builds the
kernels of the checkout DIR and times each (the forward with and without the LSE, dq,
dk/dv) against this one's at the served shape, in turns, on device time,
after holding both against the plain version; ``--fault-run`` builds
copies of the sources with planted faults (``MUTANTS``: three in the
forward, four in the backward) in a temporary directory and runs the
forward or the backward check on each and on the committed kernels,
which alone must pass, then the fused check on copies of
``mxtpu_torch/fused_train.py`` with planted faults (``FUSED_FAULTS``: a
stale data slot, a skipped replay, warm-up updates kept, a stale rate
row, moving stats not folded, a graph never captured again), each of
which must fail it; ``--ablate`` times the kernels against copies
with a part taken out or a choice undone (``ABLATIONS``: the forward's
products, softmax, item order and ping-pong; the backward's products,
its P and dS, its output stores and how they are made, its stats copy,
its register split, its ring depth and its item order), in turns, on
device time.
"""
import argparse
import atexit
import contextlib
import copy
import dataclasses
import io
import json
import logging
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings
from pathlib import Path

# the wall clock when this process began its imports: a launched
# worker's start-up is read against it
T_IMPORT = time.time()

import numpy as np  # noqa: E402
import torch  # noqa: E402

# peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -6, atol=2e-3)}
BWD_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-4),
           torch.bfloat16: dict(rtol=2 ** -6, atol=2e-3)}
BF16_REL_L2 = 1e-2
SERVED = (64, 1024, 128)   # (batch*heads, T, head_dim) at batch 8
CLIENTS, PER_CLIENT = 8, 150
MODEL = dict(vocab=8192, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
             max_len=1024, dtype="bfloat16")
K_STEPS, TRAIN_CALLS = 8, 4
# kernel launches per training step at 8 layers with remat="dots": the
# forward of each layer, then its recompute in the backward (the policy
# never sees the ctypes launch, so the Function's forward runs again),
# then one launch of each backward kernel per layer
PER_STEP = {"flash_fwd": 16, "flash_bwd_dq": 8, "flash_bwd_dkv": 8}
# bench.py's ResNet row: batch, steps, and the training FLOP per image
# (bench.py:111, forward and backward)
RESNET_BATCH, RESNET_WARM, RESNET_STEPS = 32, 2, 20
RESNET_GFLOP_PER_IMG = 12.3
# card-vs-CPU step: the output's bound (relative L2); the updates are
# held to the CPU's own distance from float64 (resnet_step_check)
RESNET_OUT_TOL = 1e-4

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py: no CUDA device is present\n")
    sys.exit(2)

import mxtpu_torch as mx  # noqa: E402
from mxtpu_torch import serve  # noqa: E402
from mxtpu_torch import telemetry  # noqa: E402
from mxtpu_torch.ops import flash_attention as fa  # noqa: E402
from mxtpu_torch.ops import kernel_build as kb  # noqa: E402
from mxtpu_torch.parallel import spmd  # noqa: E402
from mxtpu_torch.parallel import transformer as tf  # noqa: E402

KERNELS = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dq": fa.FLASH_BWD_DQ,
           "flash_bwd_dkv": fa.FLASH_BWD_DKV}
BWD_NAMES = ("flash_bwd_dq", "flash_bwd_dkv")
# the attribute of ``fa`` that holds each kernel's wrapper, and the source
# each is built from
ATTRS = {"flash_fwd": "FLASH_FWD", "flash_bwd_dq": "FLASH_BWD_DQ",
         "flash_bwd_dkv": "FLASH_BWD_DKV"}
SOURCE_OF = {"flash_fwd": "flash_fwd.cu", "flash_bwd_dq": "flash_bwd.cu",
             "flash_bwd_dkv": "flash_bwd.cu"}


def log(*args):
    print(*args, flush=True)


_CARD = []


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    if not _CARD:
        _CARD.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
    return _CARD[0]


def fail(msg):
    sys.stderr.write("chip_smoke.py FAILED: %s\n" % msg)
    sys.exit(1)


def time_ms(fn, iters):
    fn()  # warm
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def busy_us(spans):
    """Microseconds covered by the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for start, end in sorted(spans):
        if cur_e is None or start > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    return busy + (0.0 if cur_e is None else cur_e - cur_s)


def profile_summary(spans, top=8):
    """(device busy ms, window ms, the ``top`` operations with the most
    time as (name, us)) of one profiled run's spans."""
    by_name = {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    busy = busy_us([(a, b) for a, b, _ in spans])
    window = max(b for _, b, _ in spans) - min(a for a, _, _ in spans)
    return busy / 1e3, window / 1e3, sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:top]


def device_spans(fn, tries=3):
    """fn() under torch.profiler: its kernels' (start, end, name).  Now
    and then the profiler returns no device event at all (seen once in
    a dozen runs of this script); then fn runs under it again, up to
    ``tries`` times in all."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans = [(e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return spans
        log("[profiler] no device event in profile %d of %d"
            % (attempt + 1, tries))
    return spans


def device_ms(fn, iters):
    """The card's busy time per call of fn, from its kernels' intervals:
    unlike time_ms it leaves out the gaps where the card waits for the
    host, so a library call's time does not depend on the host's speed."""
    fn()  # warm
    spans = device_spans(lambda: [fn() for _ in range(iters)])
    if not spans:
        fail("the profiler saw no device time")
    return busy_us([(a, b) for a, b, _ in spans]) / 1e3 / iters


def bound_ms(nbytes, flops, dtype):
    """The least time for nbytes of traffic and flops of work: the
    larger of the bytes over the memory rate and the operations over the
    peak rate of the type; and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kept_pairs(tq, tk, causal):
    """(query, key) pairs the top-left-aligned causal mask keeps."""
    return sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk


def attention_bound_ms(bh, tq, tk, d, dtype, causal, want_lse):
    """Forward: q, k, v read once, o (and lse) written once; 4*d flops
    per kept (query, key) pair (Q K^T and P V)."""
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * bh * tq * d + 2 * bh * tk * d) * esz
    nbytes += bh * tq * 4 if want_lse else 0
    return bound_ms(nbytes, 4.0 * d * bh * kept_pairs(tq, tk, causal), dtype)


def backward_bound_ms(kernel, bh, tq, tk, d, dtype, causal):
    """flash_bwd_dq: q, k, v, g, lse and delta read once, dq written
    once; 6*d flops per kept pair (S, dP and dS K).  flash_bwd_dkv: the
    same inputs, dk and dv written once; 8*d flops per kept pair (S, dP,
    P^T G and dS^T Q)."""
    esz = torch.tensor([], dtype=dtype).element_size()
    outs, per_pair = ((bh * tq * d, 6.0) if kernel == "flash_bwd_dq"
                      else (2 * bh * tk * d, 8.0))
    nbytes = (2 * bh * tq * d + 2 * bh * tk * d + outs) * esz \
        + 2 * bh * tq * 4
    return bound_ms(nbytes, per_pair * d * bh * kept_pairs(tq, tk, causal),
                    dtype)


def error_scale(q, k, v, scale, causal, lse):
    """(P |V|) / l from the plain version's LSE: the size of the sum
    behind each output element before its terms cancel.  bf16 rounds P
    before P V, each version at its own running max, so one probability
    one ulp apart (up to 2^-7 of it) moves the output by up to 2^-7 of
    this, and the output's own rounding adds up to 2^-7 of |o|, which
    is at most this: hence bf16's rtol of 2^-6 of it."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)
        ki = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(ki[None, :] > qi[:, None], float("-inf"))
    return torch.exp(s - lse[..., None]) @ v.float().abs()


def bwd_error_scales(q, k, v, g, out, lse, scale, causal):
    """The sums behind dq, dk and dv before their terms cancel:
    |dS| |K|, |dS|^T |Q| and P^T |G|, from the plain version's blocks.
    bf16 rounds P and dS before these products, each version from its
    own f32 values, so one term one ulp apart moves a gradient by up to
    2^-8 of its term, and the gradient's own rounding adds 2^-9 of it:
    hence bf16's rtol of 2^-6 of these scales."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)
        ki = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(ki[None, :] > qi[:, None], float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", g.float(), v.float())
    ds = (p * (dp - fa._delta(out, g)[..., None]) * scale).abs()
    return (ds @ k.float().abs(), ds.transpose(1, 2) @ q.float().abs(),
            p.transpose(1, 2) @ g.float().abs())


def phase_build():
    """One nvcc for each source, started together."""
    secs, errors = {}, []

    def build(kern):
        t0 = time.monotonic()
        try:
            kern.load()
        except BaseException as e:
            errors.append("%s: %s" % (kern.source, e))
        secs[kern.source] = time.monotonic() - t0

    threads = [threading.Thread(target=build, args=(k,))
               for k in (fa.FLASH_FWD, fa.FLASH_BWD_DQ)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail("build failed: %s" % errors)
    fa.FLASH_BWD_DKV.load()  # the library flash_bwd_dq's build made
    for kern in (fa.FLASH_FWD, fa.FLASH_BWD_DQ):
        log("[build] %s built and loaded in %.2f s; registers a thread "
            "and spill stores by kernel (-Xptxas -v): %s"
            % (kern.source, secs[kern.source],
               "; ".join(kb.ptxas_summary(kern.build_log))))


def backward_reference(q, k, v, g, out, lse, scale, causal):
    """The plain backward's (dq, dk, dv) and the scales each gradient's
    bound is taken against (|grad| in f32, the sums before they cancel
    in bf16)."""
    ref = fa._flash_bwd_reference(q, k, v, g, out, lse, scale, causal)
    scales = bwd_error_scales(q, k, v, g, out, lse, scale, causal) \
        if q.dtype == torch.bfloat16 else [r.float().abs() for r in ref]
    return ref, scales


def backward_errors(q, k, v, g, out, lse, scale, causal, ref):
    """One launch of each backward kernel (``fa.FLASH_BWD_DQ``,
    ``fa.FLASH_BWD_DKV``, through ``_flash_backward_cuda``) against the
    plain backward ``ref`` (from ``backward_reference``); returns each
    gradient's errors and whether all keep to the bounds."""
    dtype = q.dtype
    got = fa._flash_backward_cuda(q, k, v, g, out, lse, scale, causal)
    torch.cuda.synchronize()
    tol = BWD_TOL[dtype]
    errs = {}
    for name, a, b, base in zip(("dq", "dk", "dv"), got, *ref):
        diff = a.float() - b.float()
        errs[name] = dict(
            max_abs_err=diff.abs().max().item(),
            err_over_tol=(diff.abs() / (tol["atol"] + tol["rtol"] * base))
            .max().item(),
            rel_l2=(diff.norm() / b.float().norm()).item())
    ok = all(e["err_over_tol"] <= 1.0 and (dtype != torch.bfloat16 or
                                          e["rel_l2"] <= BF16_REL_L2)
             for e in errs.values())
    return errs, ok


def backward_launches(q, k, v, g, out, lse, scale, causal):
    """{kernel name: a function that launches it once on these inputs}
    for both backward kernels, through ``fa``'s current wrappers (delta
    and the outputs are made once)."""
    delta = fa._delta(out, g)
    outs = {"flash_bwd_dq": (torch.empty_like(q),),
            "flash_bwd_dkv": (torch.empty_like(k), torch.empty_like(v))}
    return {n: (lambda n=n: fa._bwd_launch(
        getattr(fa, ATTRS[n]), q, k, v, g, lse, delta, outs[n], scale,
        causal)) for n in BWD_NAMES}


def check_backward(q, k, v, out, lse, scale, causal, gen):
    """Both backward kernels against the plain backward on the same
    inputs and a random cotangent; returns a record per kernel."""
    (bh, tq, d), tk, dtype = q.shape, k.shape[1], q.dtype
    g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
    errs, ok = backward_errors(q, k, v, g, out, lse, scale, causal,
                               backward_reference(q, k, v, g, out, lse,
                                                  scale, causal))
    launches = backward_launches(q, k, v, g, out, lse, scale, causal)
    iters = 20 if tq >= 1024 else 50
    plain_ms = time_ms(lambda: fa._flash_bwd_reference(
        q, k, v, g, out, lse, scale, causal), 3)
    # the backward as the autograd Function runs it: delta, the
    # allocations and both launches
    wrapper_ms = time_ms(lambda: fa._flash_backward_cuda(
        q, k, v, g, out, lse, scale, causal), iters)
    recs = {}
    for name, grads in (("flash_bwd_dq", ("dq",)),
                        ("flash_bwd_dkv", ("dk", "dv"))):
        launch = launches[name]
        ms, dev = time_ms(launch, iters), device_ms(launch, iters)
        bms, bound_by = backward_bound_ms(name, bh, tq, tk, d, dtype,
                                          causal)
        e = [errs[n] for n in grads]
        recs[name] = dict(
            kernel=name, shape="(%d,%d,%d)x(%d,%d,%d)" % (bh, tq, d, bh, tk, d),
            dtype=str(dtype).replace("torch.", ""), causal=causal,
            scale=scale,
            grads={n: errs[n] for n in grads},
            max_abs_err=max(x["max_abs_err"] for x in e),
            ms=ms, device_ms=dev, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
            bound_ms=bms,
            bound_by=bound_by, library_ms=None)
    if (bh, tq, d) == SERVED:
        # SDPA's backward (dq, dk, dv in one call): fwd + bwd minus fwd,
        # in device time
        b, h = 8, bh // 8
        q4, k4, v4 = (t.detach().view(b, h, tq, d).requires_grad_(True)
                      for t in (q, k, v))
        g4 = g.view(b, h, tq, d)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        both = device_ms(lambda: torch.autograd.grad(
            sdpa(q4, k4, v4, is_causal=True), (q4, k4, v4), g4), iters)
        fwd_only = device_ms(lambda: sdpa(q4, k4, v4, is_causal=True), iters)
        for r in recs.values():
            r["library_ms"] = both - fwd_only
    for r in recs.values():
        log("[kernel] " + json.dumps(r))
    if not ok:
        fail("backward kernels disagree with the plain version: %s" % errs)
    return recs


def make_case(shape, tk, dtype, gen):
    """q (bh, tq, d), k and v (bh, tk, d), normal, on the card."""
    bh, tq, d = shape
    return [torch.randn(bh, t, d, device="cuda", generator=gen).to(dtype)
            for t in (tq, tk, tk)]


def reference(q, k, v, scale, causal):
    """The plain version's output and LSE, and the scale each output
    element's bound is taken against (|o| in f32, the sum before it
    cancels in bf16)."""
    ref_o, ref_l = fa._reference_attention_lse(q, k, v, scale, causal)
    base = ref_o.float().abs() if q.dtype == torch.float32 else \
        error_scale(q, k, v, scale, causal, ref_l)
    return ref_o, ref_l, base


def check_forward(q, k, v, scale, causal, want_lse, ref):
    """One launch of the forward kernel (``fa.FLASH_FWD``) against the
    plain version ``ref`` (from ``reference``); returns its errors and
    whether they keep to the bounds."""
    ref_o, ref_l, base = ref
    dtype = q.dtype
    o, lse = fa._flash_forward_cuda(q, k, v, scale, causal, want_lse)
    torch.cuda.synchronize()
    d_o = o.float() - ref_o.float()
    err = d_o.abs()
    over = (err / (TOL[dtype]["atol"] + TOL[dtype]["rtol"] * base)).max().item()
    rel_l2 = (d_o.norm() / ref_o.float().norm()).item()
    # bf16 also keeps to the 0.05 bound of the TPU tests
    over_005 = (err / (0.05 + 0.05 * ref_o.float().abs())).max().item()
    ok = over <= 1.0 and (dtype != torch.bfloat16 or (
        rel_l2 <= BF16_REL_L2 and over_005 <= 1.0))
    err_lse = 0.0
    if want_lse:
        el = (lse - ref_l).abs()
        err_lse = el.max().item()
        ok = ok and torch.all(el <= 2e-5 + 2e-4 * ref_l.abs()).item()
    return dict(max_abs_err=err.max().item(), err_over_tol=over,
                rel_l2=rel_l2, err_over_0_05=over_005,
                max_abs_err_lse=err_lse), bool(ok)


class use_kernels(object):
    """Within the block, the wrappers in ``kernels`` ({name: CudaKernel},
    other builds of the same entry points) take the place of ``fa``'s,
    so that ``fa._flash_forward_cuda`` and ``fa._flash_backward_cuda``
    launch them."""

    def __init__(self, kernels):
        self.kernels = kernels

    def __enter__(self):
        self.saved = {n: getattr(fa, ATTRS[n]) for n in self.kernels}
        for n, kern in self.kernels.items():
            setattr(fa, ATTRS[n], kern)

    def __exit__(self, *exc):
        for n, kern in self.saved.items():
            setattr(fa, ATTRS[n], kern)


def phase_kernel():
    """Kernels vs plain on the card; returns the served/trained shape's
    record of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the served and trained shape, then each path (f32 on the CUDA
    # cores, bf16 on wgmma at d 64 and 128, on mma.sync at d 16 and 32)
    # at smaller head dims and ragged lengths; at d = 128, partial tiles
    # of 128 rows and keys, so the second 64-column box meets a ragged
    # edge; (3, 130, 128) and (2, 200, 64) x 330, where a whole warpgroup
    # of the backward's last 128-row block has no row before the end;
    # and a negative scale (the forward's other sign, the backward's
    # FFMA with a negative factor)
    cases = [(SERVED, 1024, torch.bfloat16, True, 1)] + [
        (shape, tk, dtype, causal, 1)
        for dtype in (torch.float32, torch.bfloat16)
        for shape, tk, causals in (((6, 384, 64), 384, (False, True)),
                                   ((2, 100, 32), 90, (False, True)),
                                   ((3, 130, 16), 130, (True,)),
                                   ((4, 1000, 128), 1000, (True,)),
                                   ((2, 200, 128), 330, (False,)),
                                   ((3, 130, 128), 130, (True,)),
                                   ((2, 200, 64), 330, (False,)))
        for causal in causals] + [((6, 384, 64), 384, torch.bfloat16, True,
                                   -1)]
    records = {}
    for (bh, tq, d), tk, dtype, causal, sign in cases:
        q, k, v = make_case((bh, tq, d), tk, dtype, gen)
        scale = sign * d ** -0.5
        ref = reference(q, k, v, scale, causal)
        for want_lse in (False, True):
            errs, ok = check_forward(q, k, v, scale, causal, want_lse, ref)
            iters = 20 if tq >= 1024 else 50
            launch = (lambda want_lse=want_lse: fa._flash_forward_cuda(
                q, k, v, scale, causal, want_lse))
            ms, dev = time_ms(launch, iters), device_ms(launch, iters)
            plain_ms = time_ms(lambda: fa._reference_attention_lse(
                q, k, v, scale, causal), 5)
            bound, bound_by = attention_bound_ms(bh, tq, tk, d, dtype,
                                                 causal, want_lse)
            rec = dict(shape="(%d,%d,%d)x(%d,%d,%d)" % (bh, tq, d, bh, tk, d),
                       dtype=str(dtype).replace("torch.", ""),
                       causal=causal, scale=scale, lse=want_lse, **errs,
                       ms=ms, device_ms=dev, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=bound_by, library_ms=None)
            if (bh, tq, d) == SERVED and not want_lse:
                b, h = 8, bh // 8
                q4, k4, v4 = (t.view(b, h, tq, d) for t in (q, k, v))
                sdpa = torch.nn.functional.scaled_dot_product_attention
                rec["library_ms"] = device_ms(
                    lambda: sdpa(q4, k4, v4, is_causal=True), iters)
                records["flash_fwd"] = rec
            if (bh, tq, d) == SERVED and want_lse:
                records["flash_fwd_lse_ms"] = ms
                records["flash_fwd_lse_device_ms"] = dev
            log("[kernel] " + json.dumps(rec))
            if not ok:
                fail("kernel disagrees with the plain version: %s" % rec)
        recs = check_backward(q, k, v, ref[0], ref[1], scale, causal, gen)
        if (bh, tq, d) == SERVED:
            records.update(recs)
    fwd = records["flash_fwd"]
    log("[kernel] flash_fwd at %s bf16 causal, device time: %.4f ms (with "
        "the LSE %.4f), SDPA's forward %.4f ms: %.2fx SDPA; %.2fx the "
        "bound %.4f ms (%s)"
        % (fwd["shape"], fwd["device_ms"], records["flash_fwd_lse_device_ms"],
           fwd["library_ms"], fwd["device_ms"] / fwd["library_ms"],
           fwd["device_ms"] / fwd["bound_ms"], fwd["bound_ms"],
           fwd["bound_by"]))
    return records


TURNS = ("baseline", "this", "this", "baseline")


def report_turns(what, times, errs):
    """One [baseline] line: device ms in turns, the means, the factor."""
    mean = {w: sum(t) / len(t) for w, t in times.items()}
    log("[baseline] %s at %s bf16 causal, device ms in turns (baseline, "
        "this, this, baseline): %s; baseline %.4f, this %.4f: %.2fx "
        "faster; errors %s"
        % (what, SERVED, json.dumps(
            [times["baseline"][0], times["this"][0], times["this"][1],
             times["baseline"][1]]), mean["baseline"], mean["this"],
           mean["baseline"] / mean["this"], json.dumps(errs)))


def phase_baseline(root):
    """The kernels of another checkout (``root``, such as the parent
    commit unpacked by ``git archive``) against this one's at the served
    shape, on device time, in turns (``TURNS``): the forward with and
    without the LSE, then each backward kernel.  Every version is also
    held against the plain version."""
    csrc = Path(root) / "mxtpu_torch" / "ops" / "csrc"
    tmp = Path(tempfile.mkdtemp(prefix="baseline-"))
    other = copy_kernels(csrc, tmp, ("flash_fwd.cu", "flash_bwd.cu"))
    t0 = time.monotonic()
    load_all([other])
    for src in ("flash_fwd.cu", "flash_bwd.cu"):
        kern = next(k for n, k in other.items() if SOURCE_OF[n] == src)
        log("[baseline] %s built (both sources together in %.2f s): %s"
            % (csrc / src, time.monotonic() - t0,
               "; ".join(kb.ptxas_summary(kern.build_log))))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = make_case(SERVED, SERVED[1], torch.bfloat16, gen)
    scale = SERVED[2] ** -0.5
    ref = reference(q, k, v, scale, True)
    ok = True
    for want_lse in (False, True):
        times, errs = {"baseline": [], "this": []}, {}
        for who in TURNS:
            with use_kernels({"flash_fwd": other["flash_fwd"]}
                             if who == "baseline" else {}):
                errs[who] = check_forward(q, k, v, scale, True, want_lse,
                                          ref)
                ok = ok and errs[who][1]
                times[who].append(device_ms(lambda: fa._flash_forward_cuda(
                    q, k, v, scale, True, want_lse), 50))
        report_turns("flash_fwd" + (" with the LSE" if want_lse else ""),
                     times, errs)
    # the backward from the plain forward's output and LSE, as
    # check_backward takes them
    out, lse = ref[0], ref[1]
    g = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    bref = backward_reference(q, k, v, g, out, lse, scale, True)
    launches = backward_launches(q, k, v, g, out, lse, scale, True)
    times = {n: {"baseline": [], "this": []} for n in BWD_NAMES}
    errs = {}
    for who in TURNS:
        with use_kernels({n: other[n] for n in BWD_NAMES}
                         if who == "baseline" else {}):
            errs[who] = backward_errors(q, k, v, g, out, lse, scale, True,
                                        bref)
            ok = ok and errs[who][1]
            for n in BWD_NAMES:
                times[n][who].append(device_ms(launches[n], 50))
    for n in BWD_NAMES:
        report_turns(n, times[n], errs)
    pair = {w: sum(sum(times[n][w]) / 2 for n in BWD_NAMES)
            for w in ("baseline", "this")}
    log("[baseline] the backward pair (dq + dk/dv), device ms: baseline "
        "%.4f, this %.4f: %.2fx faster" % (pair["baseline"], pair["this"],
                                           pair["baseline"] / pair["this"]))
    shutil.rmtree(tmp, ignore_errors=True)
    if not ok:
        fail("baseline: a kernel disagrees with the plain version")


# Faults planted in copies of the sources by phase_fault_run: each is a
# list of (file, text, replacement), and the text must occur exactly once.
# A fault in flash_fwd.cu is held to the forward check, one in
# flash_bwd.cu to the backward check.
BWD_MASK = ("        {\n          // P = 0 for columns past the end and, "
            "causal, for q < k, where\n")
MUTANTS = {
    "key tile 4 skipped": [
        ("flash_fwd.cu", "      fence_regs(sacc);\n      {\n",
         "      fence_regs(sacc);\n      if (n_tiles - 1 == 4)\n"
         "        for (int i = 0; i < BK / 2; ++i) sacc[i] = -INFINITY;\n"
         "      {\n"),
        ("flash_fwd.cu",
         "        fence_regs(sacc);\n        softmax_step(sacc, m, l, alpha, "
         "abs_scale);\n",
         "        fence_regs(sacc);\n        if (n_tiles - 1 - j == 4)\n"
         "          for (int i = 0; i < BK / 2; ++i) sacc[i] = -INFINITY;\n"
         "        softmax_step(sacc, m, l, alpha, abs_scale);\n")],
    "K box 1 never loaded or read": [
        ("flash_fwd.cu", "mbar_arrive_expect_tx(&full_k[s], T::KV_BYTES);",
         "mbar_arrive_expect_tx(&full_k[s], T::KV_BOX);"),
        ("flash_fwd.cu", "tma_load_3d(sk + ", "if (b == 0) tma_load_3d(sk + "),
        ("flash_fwd.cu", "for (int kk = 0; kk < D / 16; ++kk) {",
         "for (int kk = 0; kk < 4; ++kk) {")],
    "V transpose bit cleared": [
        ("flash_fwd.cu", "constexpr int V_TRANS = 1;",
         "constexpr int V_TRANS = 0;")],
    "dk/dv: query tile 4 skipped": [
        ("flash_bwd.cu", BWD_MASK,
         "        if (DKV && c0 == 4 * BC)\n"
         "          for (int i = 0; i < BC / 2; ++i) sacc[i] = 0.f;\n"
         + BWD_MASK)],
    "dq: key tile 4 skipped": [
        ("flash_bwd.cu", BWD_MASK,
         "        if (!DKV && c0 == 4 * BC)\n"
         "          for (int i = 0; i < BC / 2; ++i) sacc[i] = 0.f;\n"
         + BWD_MASK)],
    # at d = 128; the box's bytes are no longer expected
    "dk/dv: Q's second 64-column box never loaded": [
        ("flash_bwd.cu", "mbar_arrive_expect_tx(&full[s], 2 * T::COL_BYTES);",
         "mbar_arrive_expect_tx(&full[s], 2 * T::COL_BYTES - "
         "(DKV && D == 128 ? T::COL_BOX : 0));"),
        ("flash_bwd.cu", "              tma_load_3d(sc1 + s * T::COL_BYTES",
         "              if (!DKV || b == 0) tma_load_3d(sc1 + s * T::COL_BYTES")],
    # (G read K-major reaches 6 KB past its tile, into the stats and the
    # output buffers that follow the stages)
    "dk/dv: G's transpose bit cleared in the dv product": [
        ("flash_bwd.cu", "issue_ac<D, C_TRANS>(acc2, pa, c2t)",
         "issue_ac<D, 0>(acc2, pa, c2t)")],
}
FAULT_CASES = [(SERVED, SERVED[1], True), ((4, 1000, 128), 1000, True),
               ((2, 200, 128), 330, False)]
BWD_FAULT_CASES = [(SERVED, SERVED[1], True), ((3, 130, 128), 130, True),
                   ((2, 200, 128), 330, False)]
# Copies of the kernels with one part taken out or one choice undone,
# timed against them by phase_ablate (same form as MUTANTS): where the
# committed kernels' time goes.  Those without a product, the softmax or
# P and dS compute garbage.
HEAVIEST_FIRST = "const Item item((w % n_bh) * n_qt + w / n_bh, n_qt, tk, causal);"
BWD_HEAVIEST_FIRST = ("const Item<DKV> item((w % n_bh) * n_rb + w / n_bh, "
                      "n_rb, tq, tk, causal);")
FWD_NO_WGMMA = [
    ("flash_fwd.cu", "    wgmma_rs<V_TRANS>(oacc, pa[kk],",
     "    if (false) wgmma_rs<V_TRANS>(oacc, pa[kk],"),
    ("flash_fwd.cu", "    wgmma_ss<SIGN>(\n", "    if (false) wgmma_ss<SIGN>(\n")]
FWD_NO_SOFTMAX = [
    ("flash_fwd.cu", "        softmax_step(sacc, m, l, alpha, abs_scale);\n"
     "        pack_p(pa, sacc);\n      }\n", "      }\n")]
BWD_NO_WGMMA = [
    ("flash_bwd.cu", "    wgmma_ss(acc, desc_sw128(",
     "    if (false) wgmma_ss(acc, desc_sw128("),
    ("flash_bwd.cu", "    wgmma_rs<TRANS>(acc, a[kk],",
     "    if (false) wgmma_rs<TRANS>(acc, a[kk],")]
BWD_NO_P_DS = [
    ("flash_bwd.cu", "            sacc[4 * jj + e] =\n"
     "                exp2_approx(fmaf(sacc[4 * jj + e], scale_log2, nl));",
     "            (void)nl;"),
    ("flash_bwd.cu", "            dpacc[i] = sacc[i] * (dpacc[i] - dl) * sm_scale;",
     "            (void)dl;"),
    ("flash_bwd.cu", "          if (edge) {", "          if (false) {")]
ABLATIONS = {
    "no wgmma (loads, softmax)": FWD_NO_WGMMA,
    "no softmax (loads, products)": FWD_NO_SOFTMAX,
    "loads only": FWD_NO_WGMMA + FWD_NO_SOFTMAX,
    "items heaviest first across heads": [
        ("flash_fwd.cu", "        const Item item(w, n_qt, tk, causal);",
         "        " + HEAVIEST_FIRST),
        ("flash_fwd.cu", "      const Item item(w, n_qt, tk, causal);",
         "      " + HEAVIEST_FIRST)],
    "no ping-pong": [
        ("flash_fwd.cu",
         "      if (cw == 1 && n_tiles > 1) named_arrive(1, 256);\n", ""),
        ("flash_fwd.cu",
         "        named_sync(1 + cw, 256);  // this warpgroup's turn\n", ""),
        ("flash_fwd.cu",
         "        if (cw == 0 || j < n_tiles - 1) named_arrive(2 - cw, 256);\n",
         "")],
    "backward: no wgmma (loads, P and dS)": BWD_NO_WGMMA,
    "backward: no P and dS (loads, products)": BWD_NO_P_DS,
    "backward: loads only": BWD_NO_WGMMA + BWD_NO_P_DS,
    "backward: no output stores": [
        ("flash_bwd.cu", "    if (rbase + r < n_rows)\n", "    if (false)\n")],
    "backward: stores straight from the fragments": [
        ("flash_bwd.cu",
         "      *reinterpret_cast<uint32_t*>(buf + (g + 8 * h) * T::OUT_STRIDE +\n"
         "                                   16 * j + 4 * c) =\n",
         "      if (rbase + g + 8 * h < n_rows)\n"
         "        *reinterpret_cast<uint32_t*>(out + (size_t)(rbase + g + 8 * h)"
         " * D +\n                                     8 * j + 2 * c) =\n"),
        ("flash_bwd.cu", "    if (rbase + r < n_rows)\n", "    if (false)\n")],
    "backward: column stats through registers": [
        ("flash_bwd.cu",
         "              cp_async4(st + lane + 32 * h, l + (in ? col : 0), in);\n"
         "              cp_async4(st + BC + lane + 32 * h, dl + (in ? col : 0),"
         " in);\n",
         "              st[lane + 32 * h] = in ? l[col] : 0.f;\n"
         "              st[BC + lane + 32 * h] = in ? dl[col] : 0.f;\n"),
        ("flash_bwd.cu", "            cp_async_arrive(&full[s]);\n",
         "            mbar_arrive(&full[s]);\n")],
    "backward: setmaxnreg 24 / 240": [
        ("flash_bwd.cu", "reg_dealloc<32>();", "reg_dealloc<24>();"),
        ("flash_bwd.cu", "reg_alloc<232>();", "reg_alloc<240>();")],
    "backward: 2 stages": [
        ("flash_bwd.cu", "  static constexpr int STAGES = D == 128 ? 3 : 4;",
         "  static constexpr int STAGES = 2;")],
    "backward: items heaviest first across heads": [
        ("flash_bwd.cu", "        const Item<DKV> item(w, n_rb, tq, tk, causal);\n"
         "        if (lane == 0) {", "        " + BWD_HEAVIEST_FIRST
         + "\n        if (lane == 0) {"),
        ("flash_bwd.cu", "      const Item<DKV> item(w, n_rb, tq, tk, causal);\n"
         "      const int n_tiles", "      " + BWD_HEAVIEST_FIRST
         + "\n      const int n_tiles")],
}


def copy_kernels(csrc, build_dir, sources):
    """Wrappers ({name: CudaKernel}) of the entry points of ``sources``
    (file names), built from the directory ``csrc`` into ``build_dir``."""
    return {n: kb.CudaKernel(src, n, KERNELS[n].argtypes, csrc=csrc,
                             build_dir=build_dir)
            for n, src in SOURCE_OF.items() if src in sources}


def mutant_kernels(edits, tmp):
    """The wrappers of the sources that ``edits`` changes, built from a
    copy of the sources under ``tmp`` with ``edits`` applied."""
    csrc = tmp / "csrc"
    shutil.copytree(kb.CSRC, csrc)
    for name, text, replacement in edits:
        src = (csrc / name).read_text()
        if src.count(text) != 1:
            fail("fault run: %r occurs %d times in %s"
                 % (text, src.count(text), name))
        (csrc / name).write_text(src.replace(text, replacement))
    return copy_kernels(csrc, tmp / "build", {name for name, _, _ in edits})


def load_all(kernel_sets):
    """Build every library of ``kernel_sets`` (dicts from
    ``copy_kernels``), one nvcc for each, started together; then bind
    every entry point."""
    firsts = [next(k for n, k in ks.items() if SOURCE_OF[n] == src)
              for ks in kernel_sets for src in sorted(
                  {SOURCE_OF[n] for n in ks})]
    errors = []

    def load(kern):
        try:
            kern.load()
        except BaseException as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=load, args=(k,)) for k in firsts]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail("build failed: %s" % errors)
    for ks in kernel_sets:
        for kern in ks.values():
            kern.load()


def build_copies(named_edits, prefix):
    """Kernels built from copies of the sources, one copy for each
    (name, edits) of ``named_edits`` (see ``mutant_kernels``), started
    together; returns ({name: {kernel name: CudaKernel}}, the temporary
    directory)."""
    tmp = Path(tempfile.mkdtemp(prefix=prefix))
    kernels = {name: mutant_kernels(edits, tmp / ("c%d" % i))
               for i, (name, edits) in enumerate(named_edits.items())}
    load_all(list(kernels.values()))
    return kernels, tmp


def phase_fault_run():
    """The committed kernels and each of ``MUTANTS``: a forward mutant
    against the forward check (``check_forward``) at ``FAULT_CASES``,
    with and without the LSE; a backward mutant against the backward
    check (``backward_errors``) at ``BWD_FAULT_CASES``; all bf16.  The
    committed kernels must pass every case and each mutant fail at least
    one.  The copies are built in a temporary directory and removed."""
    mutants, tmp = build_copies(MUTANTS, "fault-run-")
    fwd = [n for n in MUTANTS if "flash_fwd" in mutants[n]]
    bwd = [n for n in MUTANTS if "flash_bwd_dq" in mutants[n]]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {name: [] for name in ["as committed"] + list(MUTANTS)}
    for shape, tk, causal in FAULT_CASES:
        q, k, v = make_case(shape, tk, torch.bfloat16, gen)
        scale = shape[2] ** -0.5
        ref = reference(q, k, v, scale, causal)
        for want_lse in (False, True):
            for name in ["as committed"] + fwd:
                with use_kernels(mutants.get(name, {})):
                    errs, ok = check_forward(q, k, v, scale, causal,
                                             want_lse, ref)
                results[name].append(dict(
                    shape="%sx%d" % (shape, tk), causal=causal,
                    lse=want_lse, err_over_tol=errs["err_over_tol"],
                    rel_l2=errs["rel_l2"],
                    max_abs_err_lse=errs["max_abs_err_lse"], ok=ok))
    for shape, tk, causal in BWD_FAULT_CASES:
        q, k, v = make_case(shape, tk, torch.bfloat16, gen)
        scale = shape[2] ** -0.5
        out, lse = fa._reference_attention_lse(q, k, v, scale, causal)
        g = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
        bref = backward_reference(q, k, v, g, out, lse, scale, causal)
        for name in ["as committed"] + bwd:
            with use_kernels(mutants.get(name, {})):
                errs, ok = backward_errors(q, k, v, g, out, lse, scale,
                                           causal, bref)
            results[name].append(dict(
                shape="%sx%d" % (shape, tk), causal=causal, backward={
                    n: [e["err_over_tol"], e["rel_l2"]]
                    for n, e in errs.items()}, ok=ok))
    shutil.rmtree(tmp, ignore_errors=True)
    verdict = {name: all(r["ok"] for r in rs) for name, rs in results.items()}
    for name, rs in results.items():
        log("[fault] %s: %s; %s" % (name, json.dumps(rs), "passes"
                                    if verdict[name] else "fails"))
    if not verdict["as committed"] or any(
            verdict[name] for name in MUTANTS):
        fail("fault run: the committed kernels must pass and every mutant "
             "fail: %s" % verdict)


def phase_ablate():
    """The committed kernels and each of ``ABLATIONS`` at the served
    shape (bf16, causal; the forward without the LSE), on device time,
    in turns (the list, then the list reversed); prints each copy's
    ptxas summary, each one's mean and whether it still agrees with the
    plain version.  A copy of flash_fwd.cu times the forward, one of
    flash_bwd.cu each backward kernel."""
    copies, tmp = build_copies(ABLATIONS, "ablate-")
    for name, kernels in copies.items():
        kern = next(iter(kernels.values()))
        log("[ablate] %s: %s" % (name, "; ".join(
            kb.ptxas_summary(kern.build_log))))
    committed = {n: getattr(fa, ATTRS[n]) for n in ATTRS}
    kernels = dict({"as committed": committed}, **copies)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = make_case(SERVED, SERVED[1], torch.bfloat16, gen)
    scale = SERVED[2] ** -0.5
    ref = reference(q, k, v, scale, True)
    out, lse = ref[0], ref[1]
    g = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    bref = backward_reference(q, k, v, g, out, lse, scale, True)
    launches = backward_launches(q, k, v, g, out, lse, scale, True)
    times, right = {}, {}
    for name in list(kernels) + list(reversed(list(kernels))):
        with use_kernels(kernels[name]):
            if "flash_fwd" in kernels[name]:
                right[name] = check_forward(q, k, v, scale, True, False,
                                            ref)[1]
                times.setdefault((name, "flash_fwd"), []).append(device_ms(
                    lambda: fa._flash_forward_cuda(q, k, v, scale, True,
                                                   False), 50))
            if "flash_bwd_dq" in kernels[name]:
                ok = backward_errors(q, k, v, g, out, lse, scale, True,
                                     bref)[1]
                right[name] = right.get(name, True) and ok
                for n in BWD_NAMES:
                    times.setdefault((name, n), []).append(device_ms(
                        launches[n], 50))
    shutil.rmtree(tmp, ignore_errors=True)
    for (name, n), t in times.items():
        log("[ablate] %s, %s: device ms %s, mean %.4f (%s the plain version)"
            % (name, n, json.dumps(t), sum(t) / len(t),
               "agrees with" if right[name] else "disagrees with"))
    if not right["as committed"]:
        fail("ablate: the committed kernels disagree with the plain version")


def breakdown(cfg, params, fwd, tokens):
    """Device time of one forward at each bucket, and of the parts of a
    batch-8 forward (layer 0's weights), from CUDA events."""
    B, T, E = tokens.shape[0], cfg.max_len, cfg.d_model
    lw = {k: params[k][0, 0] for k in ("wq", "wk", "wv", "wo", "w1", "w2")}
    x = torch.randn(B, T, E, device="cuda").to(torch.bfloat16)
    qkv = [torch.randn(SERVED, device="cuda").to(torch.bfloat16)
           for _ in range(3)]
    with torch.inference_mode():
        parts = [("forward at batch %d" % b, 5,
                  lambda b=b: fwd(params, tokens[:b])) for b in (1, 2, 4)]
        parts += [
            ("forward", 5, lambda: fwd(params, tokens)),
            ("attention block", 5, lambda: tf._attention(
                cfg, tf._as_mesh("cuda"), [x],
                *([lw[k]] for k in ("wq", "wk", "wv", "wo")))[0]),
            ("  flash kernel", 10, lambda: fa._flash_forward_cuda(
                *qkv, 128 ** -0.5, True, False)),
            ("FFN block", 5, lambda: tf._dense_ffn(x, lw["w1"], lw["w2"])),
            ("  f32 up-projection", 5, lambda: tf._matmul_f32(x, lw["w1"])),
            ("  the same as a widened f32 GEMM (not used)", 5,
             lambda: torch.matmul(x.float(), lw["w1"].float())),
            ("unembedding", 5, lambda: x @ params["unembed"]),
        ]
        times = [(name, time_ms(fn, n)) for name, n, fn in parts]
    log("[serve] device time (ms; the forward at batch 8 unless named, "
        "blocks per layer, %d layers): %s" % (cfg.n_layers, ", ".join(
            "%s %.3f" % (name.strip(), t) for name, t in times)))


def check_answer(x, out, vocab):
    if out.shape != (x.shape[0], vocab) or out.dtype != np.float32 \
            or not np.all(np.isfinite(out)):
        fail("serve: bad answer %s %s" % (out.shape, out.dtype))


def phase_serve():
    """The full-width next-token server; returns the forward kernel's
    launches during the served run."""
    cfg = tf.TransformerConfig(remat="none", **MODEL)
    T = cfg.max_len
    params = tf.init_params(cfg, "cuda", seed=0)
    log("[serve] %d parameters, %s" % (
        sum(p.numel() for p in params.values()), cfg))
    fwd = tf.make_forward(cfg, "cuda")
    dispatches = []

    def next_token(tokens):
        t0 = time.monotonic()
        logits = fwd(params, torch.from_numpy(tokens).cuda())
        out = logits[:, -1].float().cpu().numpy()
        dispatches.append((tokens.shape[0], time.monotonic() - t0))
        return out

    srv = serve.Server(max_batch=8, batch_wait_s=0.005,
                       request_timeout_s=300)
    # every bucket's first call (cuBLAS set-up) before the counted run
    warm = np.random.RandomState(1).randint(0, cfg.vocab, (8, T))
    for b in (1, 2, 4, 8):
        next_token(warm[:b].astype(np.int32))
    breakdown(cfg, params, fwd, torch.from_numpy(warm).cuda())
    dispatches.clear()

    srv.add_model("lm", next_token, input_shape=(T,), dtype="int32")
    srv.start()
    # closed loop: each client sends its next request when the last is
    # answered; the requests are made before the clock starts
    requests = []
    for i in range(CLIENTS):
        rng = np.random.RandomState(100 + i)
        requests.append([rng.randint(0, cfg.vocab, (int(rng.randint(1, 4)),
                                                    T)).astype(np.int32)
                         for _ in range(PER_CLIENT)])
    latencies, errors, first = [], [], []

    def client(i):
        try:
            for x in requests[i]:
                t0 = time.monotonic()
                out = srv.submit("lm", x).result(300)
                latencies.append(time.monotonic() - t0)
                check_answer(x, out, cfg.vocab)
                if i == 0 and not first:
                    first.append(out)
        except BaseException as e:
            errors.append(repr(e))

    for kern in KERNELS.values():
        kern.launches = 0
    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.monotonic() - t0
    n_loop = len(dispatches)
    # then one request at a time (buckets 1, 4, 2)
    rng = np.random.RandomState(0)
    for n in (1, 3, 2):
        x = rng.randint(0, cfg.vocab, (n, T)).astype(np.int32)
        check_answer(x, srv.infer("lm", x), cfg.vocab)
    launches = fa.FLASH_FWD.launches
    bwd_launches = fa.FLASH_BWD_DQ.launches + fa.FLASH_BWD_DKV.launches
    drained = srv.drain(30)
    n_req = CLIENTS * PER_CLIENT
    if errors or any(t.is_alive() for t in threads) or not drained \
            or len(latencies) != n_req:
        fail("serve: errors %s, drained %s, %d of %d answered"
             % (errors[:3], drained, len(latencies), n_req))
    if launches != 8 * len(dispatches) or not dispatches:
        fail("serve: %d kernel launches for %d dispatches (want 8 each)"
             % (launches, len(dispatches)))
    if bwd_launches:
        fail("serve: %d backward kernel launches (want none)" % bwd_launches)
    rows = sum(x.shape[0] for reqs in requests for x in reqs)
    padded = sum(b for b, _ in dispatches[:n_loop])
    busy = sum(s for _, s in dispatches[:n_loop])
    buckets = {b: sum(1 for d, _ in dispatches[:n_loop] if d == b)
               for b in (1, 2, 4, 8)}
    p50, p99 = np.percentile(np.array(latencies) * 1e3, [50, 99])
    log("[serve] closed loop, %d clients: %d requests, %d rows, %d "
        "dispatches (by bucket %s), %d kernel launches in all"
        % (CLIENTS, n_req, rows, n_loop, buckets, launches)
        + ", 0 backward launches")
    log("[serve] request latency over all %d requests (host clock): "
        "p50 %.2f ms, p99 %.2f ms, max %.2f ms"
        % (n_req, p50, p99, max(latencies) * 1e3))
    log("[serve] %d tokens in %.3f s = %.0f tokens/s served; %.0f "
        "tokens/s inside the model calls (padded buckets, %.1f%% padding); "
        "model calls take %.1f%% of the wall (host clock)"
        % (rows * T, wall, rows * T / wall, padded * T / busy,
           100.0 * (padded - rows) / padded, 100.0 * busy / wall))

    # one row against the port's forward on the CPU, in float32.  The
    # bound is bf16's over 8 layers: the bf16 residual stream against
    # f32 (measured on the CPU at half width: max 0.025, relative L2
    # 0.75%), with margin
    x = requests[0][0][:1]
    cpu_cfg = dataclasses.replace(cfg, dtype="float32")
    cpu_params = {k: v.float().cpu() for k, v in params.items()}
    t0 = time.monotonic()
    ref = tf.make_forward(cpu_cfg, "cpu")(cpu_params, x)[:, -1]
    ref = ref.numpy()
    got = first[0][:1]
    err = float(np.abs(got - ref).max())
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    log("[serve] row 0 vs the CPU float32 forward (%.1f s): max abs err "
        "%.4f, relative L2 %.5f (bounds 0.15, 0.03)"
        % (time.monotonic() - t0, err, rel))
    if not (err <= 0.15 and rel <= 0.03):
        fail("served logits disagree with the CPU forward")
    return launches


def one_member(tree):
    """A one-device tree of tensors as the transformer's per-coordinate
    lists, each tensor the one member of its list."""
    return {k: [v] for k, v in tree.items()}


def loss_and_grads(cfg, params, tok, lab):
    """The transformer's loss and gradients on the one device that holds
    ``params`` (a tree of tensors): (loss, {name: gradient})."""
    mesh = tf._as_mesh(next(iter(params.values())).device)
    loss, grads = tf._loss_and_grads(cfg, mesh, 1)(one_member(params),
                                                   [tok], [lab])
    return loss, {k: g[0] for k, g in grads.items()}


def step_breakdown(cfg, params, opt, tok, lab):
    """Device time (CUDA events) of one step's forward and loss, its
    backward and its Adam update, the parts of the port's step; the
    second of two runs."""
    mesh = tf._as_mesh("cuda")
    loss_fn = tf._build_loss_fn(cfg, mesh, 1)
    state = {"m": one_member(opt["m"]), "v": one_member(opt["v"]),
             "t": [opt["t"]]}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(2):
        leaves = {n: [p.detach().requires_grad_(True)]
                  for n, p in params.items()}
        ev[0].record()
        loss = loss_fn(leaves, [tok], [lab])[0]
        ev[1].record()
        grads = torch.autograd.grad(loss, [x[0] for x in leaves.values()])
        ev[2].record()
        tf._adam_zero1(cfg, mesh, one_member(params), state,
                       {n: [g] for n, g in zip(leaves, grads)}, 1e-3,
                       (0.9, 0.999), 1e-8)
        ev[3].record()
        torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def step_profile(cfg, params, opt, tok, lab, top=8):
    """One step under torch.profiler: the device's busy time (the union
    of its kernels' intervals), the step's window from the first kernel
    to the last, and the kernels with the most device time.  The
    profiler's own host work widens the window, so the idle share it
    gives is an upper bound."""
    step, _ = tf.make_train_step(cfg, "cuda", lr=1e-3, optimizer="adam")
    spans = device_spans(lambda: step(params, opt, tok, lab))
    if not spans:
        fail("train: the profiler saw no device time in a step")
    busy, window, heads = profile_summary(spans, top)
    log("[train] one profiled step: %d kernels, device busy %.3f ms in a "
        "%.3f ms window (idle share at most %.3f); most device time: %s"
        % (len(spans), busy, window, 1 - busy / window,
           "; ".join("%s %.3f ms" % (name[:60], t / 1e3)
                     for name, t in heads)))


def memory_reckoning(cfg, B):
    """What the training step must hold, reckoned from the config (MB)."""
    n = sum(int(np.prod(s)) for s in tf.param_shapes(cfg).values())
    T, E, F_, V = cfg.max_len, cfg.d_model, cfg.d_ff, cfg.vocab
    # saved per layer under "dots": the q, k, v and output projections
    # and the down-projection (bf16 [B*T, E]), the f32 up-projection
    saved = cfg.n_layers * (5 * B * T * E * 2 + B * T * F_ * 4)
    return dict(params_bf16=n * 2 / 1e6, grads_bf16=n * 2 / 1e6,
                adam_moments_f32=n * 8 / 1e6, logits_f32=B * T * V * 4 / 1e6,
                saved_products=saved / 1e6)


def cpu_step_check(cfg, tokens, labels):
    """One step at batch 1 and 2 layers on the card (bf16, remat
    "dots", the kernels) against the port's step on the CPU in float32
    (plain versions), from the same weights: the loss and every
    parameter's gradient.  The bounds are bf16's: the port's plain
    bf16 path against its f32 path, measured on the CPU at this shape
    over two seeds (loss within 9e-5, gradients' relative L2 at most
    0.0104, in wq and wk), with margin."""
    small = dataclasses.replace(cfg, n_layers=2)
    params = tf.init_params(small, "cuda", seed=0)
    tok, lab = tokens[:1], labels[:1]
    t0 = time.monotonic()
    loss, grads = loss_and_grads(small, params,
                                 torch.from_numpy(tok).cuda().long(),
                                 torch.from_numpy(lab).cuda().long())
    ref_cfg = dataclasses.replace(small, dtype="float32", remat="none")
    ref_loss, ref_grads = loss_and_grads(
        ref_cfg, {k: v.float().cpu() for k, v in params.items()},
        torch.from_numpy(tok).long(), torch.from_numpy(lab).long())
    d_loss = abs(loss.item() - ref_loss.item())
    rel = {k: ((grads[k].float().cpu() - ref_grads[k]).norm()
               / ref_grads[k].norm()).item() for k in ref_grads}
    worst = max(rel, key=rel.get)
    log("[train] one step vs the CPU float32 step (batch 1, 2 layers, "
        "%.1f s): loss %.5f vs %.5f (|d| %.5f, bound 0.01); gradients' "
        "relative L2 %s (worst %s %.5f, bound 0.03)"
        % (time.monotonic() - t0, loss.item(), ref_loss.item(), d_loss,
           json.dumps({k: round(v, 5) for k, v in sorted(rel.items())}),
           worst, rel[worst]))
    if not (d_loss <= 0.01 and rel[worst] <= 0.03):
        fail("the card's training step disagrees with the CPU step")


def phase_train(kernel_records):
    """bench.py's transformer row trained on the card; returns each
    kernel's launches in the 4 fused calls."""
    cfg = tf.TransformerConfig(remat="dots", **MODEL)
    B, T = 8, cfg.max_len
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, "cuda", seed=0)
    opt = tf.init_opt_state(cfg, "cuda")
    step, _ = tf.make_fused_train_steps(cfg, "cuda", K_STEPS, lr=1e-3,
                                        optimizer="adam")
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab, (K_STEPS, B, T)).astype(np.int32)
    labs = rng.randint(0, cfg.vocab, (K_STEPS, B, T)).astype(np.int32)
    toks_d, labs_d = torch.from_numpy(toks).cuda(), torch.from_numpy(labs).cuda()

    def value_sync(losses):
        # a value fetch: the last loss, and a scalar of the updated params
        float(losses[-1])
        float(params["embed"].view(-1)[0])

    for kern in KERNELS.values():
        kern.launches = 0
    params, opt, warm = step(params, opt, toks_d, labs_d)
    value_sync(warm)
    losses = [warm]
    t0 = time.monotonic()
    for _ in range(TRAIN_CALLS - 1):
        params, opt, out = step(params, opt, toks_d, labs_d)
        losses.append(out)
    value_sync(losses[-1])
    wall = time.monotonic() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).float().cpu().numpy()
    n_steps = TRAIN_CALLS * K_STEPS
    timed = (TRAIN_CALLS - 1) * K_STEPS
    log("[train] %s, Adam lr 1e-3, %d fused calls of K=%d at batch %d: "
        "losses %s" % (cfg, TRAIN_CALLS, K_STEPS, B,
                       " ".join("%.4f" % x for x in losses)))
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("train: losses not finite or not decreasing: %s" % losses)
    want = {name: n * n_steps for name, n in PER_STEP.items()}
    log("[train] kernel launches in the %d steps: %s (per step %s)"
        % (n_steps, launches, PER_STEP))
    if launches != want:
        fail("train: launches %s, want %s" % (launches, want))
    log("[train] %d timed steps in %.3f s (host clock, synchronised by "
        "value): %.1f ms per step, %.0f tokens/s"
        % (timed, wall, wall / timed * 1e3, timed * B * T / wall))
    fwd_ms, bwd_ms, upd_ms = step_breakdown(cfg, params, opt,
                                            toks_d[0].long(),
                                            labs_d[0].long())
    attn_bwd = cfg.n_layers * (kernel_records["flash_bwd_dq"]["ms"]
                               + kernel_records["flash_bwd_dkv"]["ms"])
    recompute = cfg.n_layers * kernel_records["flash_fwd_lse_ms"]
    log("[train] one step's device time (CUDA events): forward and loss "
        "%.3f ms, backward %.3f ms, Adam update %.3f ms; the attention "
        "backward kernels (%d x (dq + dk/dv) at the kernel phase's times) "
        "%.3f ms = %.1f%% of the backward, the flash forward's recompute "
        "%.3f ms = %.1f%%"
        % (fwd_ms, bwd_ms, upd_ms, cfg.n_layers, attn_bwd,
           100 * attn_bwd / bwd_ms, recompute, 100 * recompute / bwd_ms))
    log("[train] peak device memory %.1f MB (max_memory_allocated); "
        "reckoned: %s" % (peak / 1e6, json.dumps(
            {k: round(v, 1) for k, v in memory_reckoning(cfg, B).items()})))
    step_profile(cfg, params, opt, toks_d[0].long(), labs_d[0].long())
    cpu_step_check(cfg, toks[0], labs[0])
    return launches


def resnet_module(batch, ctx):
    """ResNet-50 v1 from the exported graph in a Module bound at
    ``batch`` on ``ctx``, as bench.py's ``_build_module`` binds it."""
    symbol = mx.sym.ZOO["resnet50_v1"]()
    mod = mx.mod.Module(symbol, data_names=("data0",),
                        label_names=("softmax_label",), context=ctx)
    mod.bind(data_shapes=[("data0", (batch, 3, 224, 224))],
             label_shapes=[("softmax_label", (batch,))])
    return mod


def resnet_batch(batch, ctx, seed=0):
    """bench.py's ``_synthetic_batch``: rand images, float32 labels."""
    rng = np.random.RandomState(seed)
    data = rng.rand(batch, 3, 224, 224).astype("float32")
    label = rng.randint(0, 1000, (batch,)).astype("float32")
    return mx.io.DataBatch(data=[mx.nd.array(data, ctx=ctx)],
                           label=[mx.nd.array(label, ctx=ctx)])


def cross_entropy(mod, batch):
    ce = mx.metric.CrossEntropy()
    ce.update(batch.label, mod.get_outputs())
    return ce.get()[1]


# the first step of each optimizer the step check holds, from zero
# momentum: (optimizer parameters, the exact update of a parameter from
# its gradient summed over the batch, its weight decay and its weight)
STEP_RULES = {
    "sgd": (dict(learning_rate=0.01, momentum=0.9),
            lambda grad, wd, w: -0.01 / 2 * grad),
    # NAG: g = grad / 2 + wd w, mom = g, w -= lr (g + momentum mom)
    "nag": (dict(learning_rate=0.1, momentum=0.9, wd=1e-4),
            lambda grad, wd, w: -0.1 * 1.9 * (grad / 2 + wd * w)),
}


def resnet_step_check(params, aux, optimizer="sgd", tag="resnet"):
    """One SGD (or NAG: ``optimizer``, ``STEP_RULES``) step at batch 2 on
    the card (TF32 off) against the same
    step on the CPU, from the same weights; both against the exact step
    (the CPU in float64).  At batch 2 the step is ill-conditioned: the
    global pool hands each last-stage BatchNorm a gradient nearly
    constant over its 98 elements, which its backward mostly cancels, so
    f32 rounding moves every update below it by a few percent (the CPU's
    f32 step against float64 reads it each run).  So the card's output
    must agree with the CPU's to RESNET_OUT_TOL (1e-4; it is well
    conditioned); all updates together must lie as close to the exact
    step as the CPU's f32 step does within a factor 2, and each
    parameter's update within a factor 3 (the card's and the CPU's
    rounding differ independently, and over 161 parameters the largest
    ratio of their distances reached 1.85 on an H100), each plus 1e-3 of
    the exact update and 1e-6 of the largest (the floor for the conv
    biases a BatchNorm follows, whose exact update is zero).  TF32's
    products move the output by about 1e-2 and every update by far
    more: the same step with TF32 on is printed beside it."""
    names = sorted(params)
    opt_params, exact_update = STEP_RULES[optimizer]
    # the Module's weight decay: none on what is not a weight or a gamma
    decay = {k: opt_params.get("wd", 0.0) if k.endswith(("_weight",
                                                         "_gamma"))
             else 0.0 for k in names}

    def step(ctx):
        mod = resnet_module(2, ctx)
        mod.init_params(arg_params=params, aux_params=aux)
        mod.init_optimizer(optimizer=optimizer,
                           optimizer_params=dict(opt_params))
        batch = resnet_batch(2, ctx, seed=1)
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        arg, _ = mod.get_params()
        return (mod.get_outputs()[0].asnumpy().astype(np.float64),
                {k: arg[k].asnumpy().astype(np.float64) - params[k]
                 for k in names})

    def exact_step():
        """The first step in float64 on the CPU: the update from the
        gradient (the momentum starts at zero)."""
        symbol = mx.sym.ZOO["resnet50_v1"]()
        batch = resnet_batch(2, mx.cpu(), seed=1)
        ex = symbol.simple_bind(
            ctx=mx.cpu(), type_dict={n: "float64"
                                     for n in symbol.list_arguments()},
            data0=(2, 3, 224, 224), softmax_label=(2,))
        ex.copy_params_from(dict(
            {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in params.items()},
            data0=batch.data[0], softmax_label=batch.label[0]),
            {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in aux.items()})
        ex.forward(is_train=True)
        ex.backward()
        return (ex.outputs[0].asnumpy(),
                {k: exact_update(ex.grad_dict[k].asnumpy(), decay[k],
                                 params[k].astype(np.float64))
                 for k in names})

    def err(upd, exact):
        per = {k: np.linalg.norm(upd[k] - exact[k]) for k in names}
        total = np.linalg.norm([per[k] for k in names])
        return per, total

    t0 = time.monotonic()
    ex_out, ex_upd = exact_step()
    cpu_out, cpu_upd = step(mx.cpu())
    runs = {"TF32 off": step(mx.gpu(0))}
    with tf32_on():
        runs["TF32 on"] = step(mx.gpu(0))
    norm = {k: np.linalg.norm(ex_upd[k]) for k in names}
    all_norm = np.linalg.norm([norm[k] for k in names])
    cpu_per, cpu_all = err(cpu_upd, ex_upd)
    floor = 1e-6 * max(norm.values())
    allowed = {k: 3 * cpu_per[k] + 1e-3 * norm[k] + floor for k in names}
    log("[%s] one %s step at batch 2, CPU float32 vs float64: output "
        "%.3g, all updates %.3g (relative L2)"
        % (tag, optimizer, np.linalg.norm(cpu_out - ex_out)
           / np.linalg.norm(ex_out), cpu_all / all_norm))
    verdict = {}
    for name, (out, upd) in runs.items():
        per, total = err(upd, ex_upd)
        ratio = {k: per[k] / allowed[k] for k in names}
        worst = max(ratio, key=ratio.get)
        out_rel = float(np.linalg.norm(out - cpu_out)
                        / np.linalg.norm(cpu_out))
        verdict[name] = (out_rel, ratio[worst],
                         total / (2 * cpu_all + 1e-3 * all_norm))
        log("[%s] one %s step at batch 2, card (%s): output vs CPU %.3g "
            "(relative L2, bound %g); vs float64 all updates %.3g "
            "(relative L2), %.3g of its bound; worst parameter %s at %.3g "
            "of its bound (its update %.3g off, the CPU's %.3g)"
            % (tag, optimizer, name, out_rel, RESNET_OUT_TOL,
               total / all_norm,
               verdict[name][2], worst, ratio[worst],
               per[worst] / max(norm[worst], 1e-300),
               cpu_per[worst] / max(norm[worst], 1e-300)))
    log("[%s] the step checks took %.1f s" % (tag, time.monotonic() - t0))
    out_rel, worst, total = verdict["TF32 off"]
    if not (out_rel <= RESNET_OUT_TOL and worst <= 1 and total <= 1):
        fail("%s: the card's %s step disagrees with the CPU step"
             % (tag, optimizer))


class tf32_on:
    """The ops' float32 numerics with TF32 allowed, for a comparison
    (every convolution, product and RNN op turns it off before it runs:
    ``ops.registry.float32_numerics``)."""

    def __enter__(self):
        self.saved = mx.ops.registry.float32_numerics
        mx.ops.registry.float32_numerics = lambda tensors: None
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        mx.ops.registry.float32_numerics = self.saved
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def phase_resnet():
    """bench.py's per-step ResNet-50 row on the card through the traced
    symbol and Module; fails on any check."""
    torch.cuda.reset_peak_memory_stats()
    gpu = mx.gpu(0)
    t0 = time.monotonic()
    mod = resnet_module(RESNET_BATCH, gpu)
    mx.random.seed(0)
    mod.init_params(initializer=mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.01, "momentum": 0.9})
    batch = resnet_batch(RESNET_BATCH, gpu)
    params0, aux0 = mod.get_params()
    params0 = {k: v.asnumpy() for k, v in params0.items()}
    aux0 = {k: v.asnumpy() for k, v in aux0.items()}
    log("[resnet] ResNet-50 v1 traced by the port's gluon: %d arguments, "
        "%d aux states, bound and initialised on %s in %.1f s"
        % (len(mod.symbol.list_arguments()),
           len(mod.symbol.list_auxiliary_states()), gpu,
           time.monotonic() - t0))
    weight = mod._exec_group.param_arrays[0][0]

    def step():
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    def value_sync():
        # a value fetch: the last output, and a scalar of an updated
        # parameter (bench.py:329-333)
        out = float(mod.get_outputs()[0]._data[0, 0])
        float(weight._data.view(-1)[0])
        return out

    for kern in KERNELS.values():
        kern.launches = 0
    step()
    value_sync()
    first_ce = cross_entropy(mod, batch)
    for _ in range(RESNET_WARM - 1):
        step()
    value_sync()
    t0 = time.monotonic()
    for _ in range(RESNET_STEPS):
        step()
    value_sync()
    wall = time.monotonic() - t0
    out = mod.get_outputs()[0].asnumpy()
    last_ce = cross_entropy(mod, batch)
    peak = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in KERNELS.items()}
    ms = wall / RESNET_STEPS * 1e3
    log("[resnet] %d timed steps at batch %d (after %d warm): %.3f s "
        "(host clock, synchronised by value): %.3f ms a step; "
        "resnet50_train_imgs_per_sec_bs%d_per_step %.2f"
        % (RESNET_STEPS, RESNET_BATCH, RESNET_WARM, wall, ms,
           RESNET_BATCH, RESNET_STEPS * RESNET_BATCH / wall))
    log("[resnet] cross-entropy on the fixed batch: first step %.4f, last "
        "step %.4f" % (first_ce, last_ce))
    if out.shape != (RESNET_BATCH, 1000) or not np.all(np.isfinite(out)):
        fail("resnet: outputs %s not finite or misshapen" % (out.shape,))
    if not last_ce < first_ce:
        fail("resnet: cross-entropy did not fall (%.4f -> %.4f)"
             % (first_ce, last_ce))
    _, aux = mod.get_params()
    aux = {k: v.asnumpy() for k, v in aux.items()}
    still = [k for k in aux if np.array_equal(aux[k], aux0[k])]
    bad_var = [k for k in aux if k.endswith("_var")
               and not np.all(aux[k] > 0)]
    log("[resnet] BN moving stats: %d of %d moved; moving_var min %.4g"
        % (len(aux) - len(still), len(aux),
           min(aux[k].min() for k in aux if k.endswith("_var"))))
    if still or bad_var:
        fail("resnet: moving stats unmoved %s or non-positive %s"
             % (still[:3], bad_var[:3]))
    log("[resnet] flash-attention launches in the phase: %s" % launches)
    if any(launches.values()):
        fail("resnet: a flash-attention kernel launched: %s" % launches)
    spans = device_spans(step)
    if not spans:
        fail("resnet: the profiler saw no device time in a step")
    busy, window, heads = profile_summary(spans)
    log("[resnet] one profiled step: %d device operations, device busy "
        "%.3f ms in a %.3f ms window (idle share at most %.3f); most "
        "device time: %s" % (len(spans), busy, window,
                             1 - busy / window, "; ".join(
                                 "%s %.3f ms" % (name[:70], t / 1e3)
                                 for name, t in heads)))
    bound, by = bound_ms(0, RESNET_BATCH * RESNET_GFLOP_PER_IMG * 1e9,
                         torch.float32)
    log("[resnet] peak device memory %.1f MB (max_memory_allocated); the "
        "step's fp32 bound %.3f ms (%d x %.1f GFLOP at 67 TFLOP/s, by %s): "
        "the step is %.2fx it, the busy time %.2fx"
        % (peak / 1e6, bound, RESNET_BATCH, RESNET_GFLOP_PER_IMG, by,
           ms / bound, busy / bound))
    resnet_step_check(params0, aux0)
    return dict(launches=launches, ms=ms,
                imgs_per_sec=RESNET_STEPS * RESNET_BATCH / wall,
                busy_ms=busy, idle=1 - busy / window, ops=len(spans),
                peak_mb=peak / 1e6)


# bench.py's fused ResNet rows (run_config, bench.py:155-204, and
# :397-412): K = 16 steps a call (SPP, bench.py:100), 2 warm and 4 timed
# calls (bench.py runs 3 windows of 8), SGD lr 0.01 momentum 0.9
FUSED_K, FUSED_WARM, FUSED_CALLS = 16, 2, 4
FUSED_ROWS = (("resnet50_train_imgs_per_sec_bs32", 32, None),
              ("bf16_bs32_imgs_per_sec", 32, "bfloat16"),
              ("bf16_bs128_imgs_per_sec", 128, "bfloat16"))
# the fused-against-per-step check: K = 4 steps at batch 32, fp32, SGD
# momentum 0.9 at a rate that halves every step (so that a rate row
# left stale shows)
FUSED_CHECK_K = 4
# the first bf16 call's first output against the fp32 forward from the
# same state, on the logits (the log-probabilities less their mean over
# the classes: the logits less theirs).  Floor: the bf16 forward rounds
# its logits to bf16 (unit roundoff 2^-8), an error of about 2^-8 /
# sqrt(3) = 2.3e-3 of each logit, and more of the logits less their
# mean; an fp32 forward (TF32 off) reads about 1e-6.  Ceiling: a forward
# that computes another function (unrelated logits of the same size)
# reads about sqrt(2), zero logits read 1; below 0.3 the bf16 logits
# keep the fp32 logits' direction (cosine above 0.95).  The exact
# check of the bf16 policy is tests/test_torch_amp.py's, on the CPU.
BF16_LOGIT_FLOOR, BF16_LOGIT_CEIL = 1e-3, 0.3
# planted faults of the loop (``--fault-run``): edits of copies of
# mxtpu_torch/fused_train.py, each of which the fused check must fail
FUSED_FAULTS = {
    "stale data slot": [("slot.copy_(stack[k])", "slot.copy_(stack[0])")],
    "a replay skipped": [("self._graph.replay()",
                          "self._graph.replay() if k != 1 else None")],
    "warm-up updates kept": [("                t.copy_(s)\n",
                              "                pass\n")],
    "stale rate row": [("self._lr_row.copy_(lr_rows[k])",
                        "self._lr_row.copy_(lr_rows[0])")],
    "moving stats not folded": [("                    a.copy_(v)\n",
                                 "                    pass\n")],
    "never captured again": [(
        "if self._graph is not None and key == self._graph_key:",
        "if self._graph is not None:")],
}
# the CUDA runtime calls a host makes to put work on the card
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def free_card():
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def fused_module(batch, dtype, lr=0.01):
    """ResNet-50 v1 bound at ``batch`` on the card under the AMP policy
    ``dtype`` (bench.py's ``_build_module``), Xavier after
    ``random.seed(0)``, SGD with momentum 0.9."""
    with mx.amp.scope(dtype):
        mod = resnet_module(batch, mx.gpu(0))
    mx.random.seed(0)
    mod.init_params(initializer=mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": lr, "momentum": 0.9})
    return mod


def device_batches(batch, k, seed):
    """``k`` synthetic batches drawn on the card (uniform images, integer
    labels in float32, as bench.py's ``_synthetic_batch``): drawing 16 x
    128 images on the host would take seconds."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    data = torch.rand((k, batch, 3, 224, 224), generator=gen, device="cuda")
    label = torch.randint(0, 1000, (k, batch), generator=gen,
                          device="cuda").float()
    return [mx.io.DataBatch([mx.nd.NDArray(data[i])],
                            [mx.nd.NDArray(label[i])]) for i in range(k)]


def training_state(mod):
    """Clones of the parameters, the optimizer's states and the moving
    stats, by group."""
    g = mod._exec_group
    return {"weights": {n: a[0]._data.clone()
                        for n, a in zip(g.param_names, g.param_arrays)},
            "momenta": {"state%d" % i: st._data.clone()
                        for i, st in mod._updater.states.items()
                        if st is not None},
            "moving stats": {n: a[0]._data.clone()
                             for n, a in zip(g.aux_names, g.aux_arrays)}}


def state_distance(a, b):
    """For each group of ``training_state``: (the relative L2 of a
    against b over the group's tensors together, the three tensors with
    the largest share of the group's squared distance as (name, share,
    the tensor's own relative L2))."""
    out = {}
    for grp, want in b.items():
        sq = {k: float((a[grp][k].double() - v.double()).norm()) ** 2
              for k, v in want.items()}
        norm = {k: float(v.double().norm()) for k, v in want.items()}
        tot = sum(sq.values())
        top = sorted(sq, key=sq.get, reverse=True)[:3]
        out[grp] = ((tot / sum(n * n for n in norm.values())) ** 0.5,
                    [(k, sq[k] / tot if tot else 0.0,
                      sq[k] ** 0.5 / max(norm[k], 1e-30)) for k in top])
    return out


def show_distance(d):
    return "; ".join("%s %.4g (%s)" % (grp, rel, ", ".join(
        "%s %.2f of it, own %.3g" % (k, share, own)
        for k, share, own in top)) for grp, (rel, top) in d.items())


def within(got, ref):
    """The groups of ``got`` beyond twice ``ref``'s distance."""
    return [grp for grp, (rel, _) in got.items() if not rel <= 2 * ref[grp][0]]


def load_loop_variant(name, edits, tmp):
    """FusedTrainLoop from a copy of mxtpu_torch/fused_train.py with
    ``edits`` (old, new) made, each of which must match once."""
    import importlib.util

    src = (Path(mx.__file__).parent / "fused_train.py").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            fail("fault %r: %r matches %d times" % (name, old,
                                                     src.count(old)))
        src = src.replace(old, new)
    path = tmp / ("fused_fault_%d.py" % len(list(tmp.iterdir())))
    path.write_text(src)
    spec = importlib.util.spec_from_file_location(
        "mxtpu_torch._" + path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FusedTrainLoop


def fused_check(faults=False):
    """K = 4 fused steps against 4 per-step steps from the same state at
    batch 32, fp32, twice: from a new loop, then again from the start
    after ``init_optimizer(force_init=True)`` replaced the optimizer and
    its states (the loop must capture again).  The weights, the momenta
    and the moving stats, each group on its own, within twice the
    group's distance between two per-step runs from that state (cuDNN's
    weight gradients are not bitwise reproducible); prints how that
    distance grows step by step and the tensors that carry it.  Then
    the same runs under cuDNN's deterministic algorithms: the fused
    steps must equal the per-step steps bitwise.  With ``faults``, the
    loops of ``FUSED_FAULTS`` too: each must fail the bound."""
    t0 = time.monotonic()
    mod = fused_module(RESNET_BATCH, None)
    batches = device_batches(RESNET_BATCH, FUSED_CHECK_K, seed=1)
    start = training_state(mod)
    g = mod._exec_group

    def restart():
        for n, a in zip(g.param_names + g.aux_names,
                        g.param_arrays + g.aux_arrays):
            a[0]._data.copy_(start["weights"].get(n, start["moving stats"]
                                                  .get(n)))
        mod.init_optimizer(optimizer="sgd", force_init=True,
                           optimizer_params={
                               "learning_rate": 0.01, "momentum": 0.9,
                               "lr_scheduler": mx.lr_scheduler
                               .FactorScheduler(step=1, factor=0.5)})

    def per_step(every_step=False):
        restart()
        states = []
        for b in batches:
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
            if every_step:
                states.append(training_state(mod))
        return states if every_step else training_state(mod)

    def fused(loop_cls):
        restart()
        loop = loop_cls(mod, steps_per_program=FUSED_CHECK_K)
        loop.run(batches)
        first = training_state(mod)
        restart()
        loop.run(batches)
        return [first, training_state(mod)], loop

    # under cuDNN's default algorithms, whose weight gradients are not
    # reproducible: the bound
    runs = [per_step(every_step=True) for _ in range(2)]
    ref = state_distance(runs[1][-1], runs[0][-1])
    for k in range(FUSED_CHECK_K):
        log("[fused] two per-step runs after step %d: %s" % (k + 1, "; ".join(
            "%s %.4g" % (grp, rel) for grp, (rel, _) in
            state_distance(runs[1][k], runs[0][k]).items())))
    want = runs[0][-1]
    del runs
    got, loop = fused(mx.FusedTrainLoop)
    dists = [state_distance(x, want) for x in got]
    bad = [within(d, ref) for d in dists]
    log("[fused] K = %d fused steps vs %d per-step steps from one state "
        "(batch %d, fp32, %d tensors): by group, the relative L2 and the "
        "tensors with the largest shares of it: first call %s; after "
        "init_optimizer(force_init=True) %s; two per-step runs %s; "
        "bound twice those; %d captures, the last %.2f s; %.1f s in all"
        % (FUSED_CHECK_K, FUSED_CHECK_K, RESNET_BATCH,
           sum(len(v) for v in want.values()), show_distance(dists[0]),
           show_distance(dists[1]), show_distance(ref), loop.captures,
           loop.capture_seconds, time.monotonic() - t0))
    if any(bad) or loop.captures != 2:
        fail("fused: fused steps beyond twice two per-step runs' distance "
             "in %s, or %d captures where 2" % (bad, loop.captures))
    del loop, got
    torch.backends.cudnn.deterministic = True
    try:
        det = [per_step() for _ in range(2)]
        det_fused, loop = fused(mx.FusedTrainLoop)
    finally:
        torch.backends.cudnn.deterministic = False
    det_dists = [state_distance(x, det[0]) for x in det[1:] + det_fused]
    log("[fused] under cuDNN's deterministic algorithms, against a "
        "per-step run: another per-step run %s; the fused steps, first "
        "call %s; after init_optimizer(force_init=True) %s" % tuple(
            "; ".join("%s %.4g" % (grp, rel) for grp, (rel, _) in d.items())
            for d in det_dists))
    if any(rel != 0 for d in det_dists for rel, _ in d.values()):
        fail("fused: under cuDNN's deterministic algorithms the fused "
             "steps or a second per-step run differ from the per-step "
             "steps")
    del det, det_fused, loop
    if faults:
        tmp = Path(tempfile.mkdtemp(prefix="fused-faults-"))
        caught = {}
        for name, edits in FUSED_FAULTS.items():
            got, loop = fused(load_loop_variant(name, edits, tmp))
            dists = [state_distance(x, want) for x in got]
            bad = [within(d, ref) for d in dists]
            caught[name] = any(bad)
            log("[fault] fused loop, %s: first call %s; second %s; beyond "
                "the bound in %s: %s" % (
                    name, "; ".join("%s %.4g" % (grp, rel) for grp, (rel, _)
                                    in dists[0].items()),
                    "; ".join("%s %.4g" % (grp, rel) for grp, (rel, _)
                              in dists[1].items()),
                    bad, "fails" if caught[name] else "passes"))
            del got, loop
        shutil.rmtree(tmp, ignore_errors=True)
        if not all(caught.values()):
            fail("fault run: a planted fault of the fused loop passed the "
                 "fused check: %s" % caught)
    del mod, want, start
    free_card()
    log("[fused] %.1f MB allocated after the check"
        % (torch.cuda.memory_allocated() / 1e6))


def fused_rng_check():
    """A graph with a random op draws fresh numbers on every replay: a
    net whose logits add a uniform draw, at lr 0, so that its outputs
    differ only by the draws."""
    logits = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                   name="fc")
    out = mx.sym.SoftmaxOutput(mx.sym.elemwise_add(
        logits, mx.sym.random_uniform(shape=(8, 4))),
        mx.sym.Variable("softmax_label"), name="softmax")
    mod = mx.mod.Module(out, context=mx.gpu(0))
    mod.bind([("data", (8, 3))], [("softmax_label", (8,))])
    mod.init_params()
    mod.init_optimizer(optimizer_params={"learning_rate": 0.0})
    loop = mx.FusedTrainLoop(mod, steps_per_program=3)
    zeros = [mx.io.DataBatch([mx.nd.zeros((8, 3))], [mx.nd.zeros((8,))])
             for _ in range(3)]
    outs = torch.cat([loop.run(zeros)[0]._data for _ in range(2)])
    same = sum(int(torch.equal(outs[i], outs[j])) for i in range(6)
               for j in range(i))
    log("[fused] a graph with a random op (torch %s, "
        "CUDAGraph.register_generator_state %s): 6 replays, %d equal "
        "pairs of outputs" % (torch.__version__, hasattr(
            torch.cuda.CUDAGraph, "register_generator_state"), same))
    if same:
        fail("fused: a replay repeated another's random draws")


# device operations by kind, first match wins: cuDNN's convolutions
# (and their layout transposes), the optimizer's foreach kernels,
# reductions (BatchNorm's statistics and gradients), copies and casts,
# the other elementwise kernels
KINDS = (("convolution", ("cudnn", "xmma", "implicit_gemm", "wgrad",
                          "dgrad", "fprop", "nchwToNhwc", "nhwcToNchw")),
         ("optimizer", ("multi_tensor_apply",)),
         ("reduction", ("reduce_kernel",)),
         ("copy and cast", ("direct_copy", "copy_kernel")),
         ("elementwise", ("elementwise",)))


def kind_of(name, kinds=KINDS):
    return next((k for k, keys in kinds if any(key in name for key in keys)),
                "other")


def by_kind(spans, kinds=KINDS):
    """Device time (us) of the spans by ``kinds``, the rest as other."""
    out = {}
    for start, end, name in spans:
        kind = kind_of(name, kinds)
        out[kind] = out.get(kind, 0.0) + (end - start)
    return out


def profile_call(fn):
    """fn() under torch.profiler: its device operations' (start, end,
    name), and how many CUDA runtime calls put work on the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, host = [], 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name in HOST_LAUNCH_CALLS:
            host += 1
    return spans, host


def fused_row(name, batch, dtype):
    """One of bench.py's fused rows: ResNet-50 v1 at ``batch`` under the
    policy ``dtype``, K = 16 steps a call on one stack of 16 batches, 2
    warm and 4 timed calls synchronised by value, then one profiled
    call, then one more.  The timed and profiled calls collect no
    outputs, as bench.py's loop (``collect_outputs=False``); the first
    and the last call collect them for the checks.  Fails on any
    check."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    mod = fused_module(batch, dtype)
    ex = mod._exec_group.execs[0]
    aux0 = {n: a[0]._data.clone() for n, a in zip(mod._exec_group.aux_names,
                                                  mod._exec_group.aux_arrays)}
    loop = mx.FusedTrainLoop(mod, steps_per_program=FUSED_K)
    stack = loop.stack_batches(device_batches(batch, FUSED_K, seed=0))
    labels = stack[1].long()
    ref = None
    if dtype is not None:
        # the fp32 forward (training mode) from the same state on the
        # first batch, by an executor bound without the policy
        ex32 = mod.symbol.simple_bind(ctx=mx.gpu(0), grad_req="null",
                                      data0=(batch, 3, 224, 224),
                                      softmax_label=(batch,))
        ex32.copy_params_from(mod._arg_params, mod._aux_params)
        ref = ex32.forward(is_train=True, data0=mx.nd.NDArray(stack[0][0]),
                           softmax_label=mx.nd.NDArray(stack[1][0]))[0]._data
        del ex32
    setup_s = time.monotonic() - t0
    for kern in KERNELS.values():
        kern.launches = 0
    weight = mod._exec_group.param_arrays[0][0]

    def value_sync():
        # a scalar of a parameter the last step updated (the stream runs
        # in order, so every step before it is done)
        float(weight._data.view(-1)[0])

    def cross_entropy_of(outs):
        p = outs[0]._data.gather(2, labels.unsqueeze(2)).squeeze(2)
        return float(-torch.log(p.clamp_min(1e-30)).mean())

    first = loop.run_stacked(stack)
    capture_s = loop.capture_seconds
    loop.collect_outputs = False
    for _ in range(FUSED_WARM - 1):
        loop.run_stacked(stack)
    value_sync()
    t1 = time.monotonic()
    for _ in range(FUSED_CALLS):
        loop.run_stacked(stack)
    value_sync()
    wall = time.monotonic() - t1
    steps = FUSED_CALLS * FUSED_K
    ms, ips = wall / steps * 1e3, steps * batch / wall
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    spans, host = profile_call(lambda: loop.run_stacked(stack))
    loop.collect_outputs = True
    last = loop.run_stacked(stack)
    calls = [first, last]
    peak_tflops = PEAK_FLOPS[torch.float32 if dtype is None
                             else torch.bfloat16]
    mfu = ips * RESNET_GFLOP_PER_IMG * 1e9 / peak_tflops
    log("[fused] %s: %d timed calls of K = %d at batch %d (after %d warm; "
        "%s): %.3f s (host clock, synchronised by value): %.3f ms a step; "
        "%s %.2f; mfu %.4f (%.1f GFLOP an image at %.0f TFLOP/s); set-up "
        "%.1f s, capture %.2f s (%d capture)"
        % (name, FUSED_CALLS, FUSED_K, batch, FUSED_WARM,
           dtype or "fp32, TF32 off", wall, ms, name, ips, mfu,
           RESNET_GFLOP_PER_IMG, peak_tflops / 1e12, setup_s, capture_s,
           loop.captures))
    if spans:
        busy = busy_us([(a, b) for a, b, _ in spans]) / 1e3
        window = (max(b for _, b, _ in spans)
                  - min(a for a, _, _ in spans)) / 1e3
        by_name = {}
        for a, b, n in spans:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        heads = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        kinds = sorted(by_kind(spans).items(), key=lambda kv: -kv[1])
        log("[fused] %s: device time a step by kind: %s" % (name, "; ".join(
            "%s %.3f ms" % (k, t / 1e3 / FUSED_K) for k, t in kinds)))
        log("[fused] %s: one profiled call (collecting no outputs): device "
            "busy %.3f ms a step in a %.3f ms window a step (idle share at "
            "most %.3f); %.1f device operations and %.2f host launches a "
            "step (graph replays and copies); most device time a step: %s"
            % (name, busy / FUSED_K, window / FUSED_K, 1 - busy / window,
               len(spans) / FUSED_K, host / FUSED_K, "; ".join(
                   "%s %.3f ms" % (n[:70], t / 1e3 / FUSED_K)
                   for n, t in heads)))
    else:
        log("[fused] %s: the profiler saw no device operation in a call of "
            "graph replays: device busy time not measured; %.2f host "
            "launches a step" % (name, host / FUSED_K))
    log("[fused] %s: peak device memory %.1f MB allocated, %.1f MB reserved "
        "(the graph's pool included; %.1f MB were allocated before the "
        "row)" % (name, peak / 1e6, peak_reserved / 1e6, before / 1e6))
    if not all(bool(torch.isfinite(c[0]._data).all()) for c in calls):
        fail("fused %s: outputs not finite" % name)
    if calls[-1][0].shape != (FUSED_K, batch, 1000):
        fail("fused %s: outputs of shape %s" % (name, calls[-1][0].shape))
    ce_first, ce_last = cross_entropy_of(first), cross_entropy_of(last)
    log("[fused] %s: cross-entropy over a call, the first call %.4f, the "
        "call after the timed and profiled ones %.4f" % (name, ce_first,
                                                         ce_last))
    if not ce_last < ce_first:
        fail("fused %s: cross-entropy did not fall (%.4f -> %.4f)"
             % (name, ce_first, ce_last))
    still = [n for n, a in zip(mod._exec_group.aux_names,
                               mod._exec_group.aux_arrays)
             if torch.equal(a[0]._data, aux0[n])]
    bad_var = [n for n, a in zip(mod._exec_group.aux_names,
                                 mod._exec_group.aux_arrays)
               if n.endswith("_var") and not bool((a[0]._data > 0).all())]
    log("[fused] %s: BN moving stats: %d of %d moved; flash-attention "
        "launches %s" % (name, len(aux0) - len(still), len(aux0), launches))
    if still or bad_var:
        fail("fused %s: moving stats unmoved %s or non-positive %s"
             % (name, still[:3], bad_var[:3]))
    if any(launches.values()):
        fail("fused %s: a flash-attention kernel launched: %s"
             % (name, launches))
    # cuDNN's convolutions, its layout transposes left out
    convs = {n for _, _, n in spans if kind_of(n) == "convolution"
             and "Nhwc" not in n and "Nchw" not in n}
    convs_bf16 = sorted(n for n in convs if "bf16" in n or "bfloat16" in n)
    log("[fused] %s: %d convolution kernels in the profiled call, %d of "
        "them bf16: %s" % (name, len(convs), len(convs_bf16),
                           "; ".join(n[:90] for n in convs_bf16[:4])))
    if bool(convs_bf16) != (dtype is not None):
        fail("fused %s: %d bf16 convolution kernels under %s"
             % (name, len(convs_bf16), dtype or "fp32"))
    if dtype is not None:
        wide = [n for n, a in ex.arg_dict.items()
                if a._data.dtype != torch.float32]
        wide += ["state%d" % i for i, st in mod._updater.states.items()
                 if st._data.dtype != torch.float32]
        got, want = (torch.log(t.double().clamp_min(1e-300))
                     for t in (first[0]._data[0], ref))
        got, want = (t - t.mean(dim=1, keepdim=True) for t in (got, want))
        err = float((got - want).norm() / want.norm())
        log("[fused] %s: the first step's logits (log-probabilities less "
            "their mean) vs the fp32 forward's from the same state: %.4g "
            "(relative L2, between %g and %g); parameters and states not "
            "float32: %s" % (name, err, BF16_LOGIT_FLOOR, BF16_LOGIT_CEIL,
                             wide))
        if wide or not BF16_LOGIT_FLOOR <= err <= BF16_LOGIT_CEIL:
            fail("fused %s: bf16 check failed (%.4g; %s)" % (name, err,
                                                            wide[:3]))
    result = dict(ms=ms, imgs_per_sec=ips, mfu=mfu, launches=launches)
    del loop, mod, ex, calls, first, last, stack, labels, ref, aux0
    free_card()
    return result


def phase_fused():
    """bench.py's three fused ResNet rows through FusedTrainLoop, after
    the fused-against-per-step and random-draw checks."""
    free_card()
    fused_check()
    fused_rng_check()
    return {name: fused_row(name, batch, dtype)
            for name, batch, dtype in FUSED_ROWS}


# the gluon rows (bench.py:114-136's network trained as README.md's
# first example: hybridize(), record(), SoftmaxCrossEntropyLoss,
# backward, Trainer.step), batch 32, 2 warm and 20 timed steps; the
# bf16 row traced inside amp.scope("bfloat16"), as bench.py:118 traces
GLUON_ROWS = (("gluon_resnet50_fp32_bs32", None),
              ("gluon_resnet50_bf16_bs32", "bfloat16"))
GLUON_WARM, GLUON_STEPS = 2, 20
# one Trainer step against one Module step from the same state under
# cuDNN's deterministic algorithms, by group (relative L2; PERF.md §6
# holds the prediction, written before the first run): the forward is
# the same graph on the same kernels, so the moving stats are equal; the
# gradients differ only at the head, where gluon's loss gives
# exp(log_softmax(z)) - onehot and SoftmaxOutput softmax(z) - onehot, a
# few ulps apart, which the backward carries into every gradient (the
# fused check's runs read a 1e-7 difference in step 1's weight
# gradients as 5.5e-6 on the momenta).  A wrong rescale, rate or momentum reads 1e-2 or more.
GLUON_MODULE_TOL = {"weights": 1e-5, "momenta": 1e-4, "moving stats": 0.0}
# the attention block through gluon at the transformer's shape
# (batch, heads, T, head_dim), bf16
GLUON_ATTN = (8, 8, 1024, 128)


def gluon_resnet(ctx, hybridize=True):
    """ResNet-50 v1 through gluon, built in a fresh NameManager (so its
    names are the Module graph's), Xavier after ``random.seed(0)``: the
    draws happen at the first forward, which infers the deferred
    shapes."""
    with mx.sym.NameManager():
        net = mx.gluon.model_zoo.vision.resnet50_v1(classes=1000)
    mx.random.seed(0)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    if hybridize:
        net.hybridize()
    return net


def gluon_trainer(net):
    return mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.01, "momentum": 0.9}, kvstore="device")


def gluon_step(net, trainer, loss_fn, x, y):
    """README.md's step: the loss under record(), backward, and
    Trainer.step over the batch."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def gluon_state(net, trainer):
    """Clones of the weights, the momenta and the moving stats, by group
    and parameter name."""
    params = list(net.collect_params().values())
    return {"weights": {p.name: p.data()._data.clone() for p in params
                        if p.grad_req != "null"},
            "momenta": {params[i].name: st._data.clone()
                        for i, st in trainer._updater.states.items()
                        if st is not None},
            "moving stats": {p.name: p.data()._data.clone() for p in params
                             if p.grad_req == "null"}}


def gluon_host_split(net, trainer, loss_fn, x, y, steps=5):
    """The host's ms a step in each stage of README.md's step (the
    hybridized forward, the imperative loss, ``backward``,
    ``Trainer.step``): the host clock around each call, with no sync
    inside the step and one after it, so each step starts on an empty
    launch queue; the median over ``steps``.  A stage that fills the
    queue also counts its wait for the card."""
    times = []
    for _ in range(steps):
        t = [time.perf_counter()]
        with mx.autograd.record():
            out = net(x)
            t.append(time.perf_counter())
            loss = loss_fn(out, y)
            t.append(time.perf_counter())
        loss.backward()
        t.append(time.perf_counter())
        trainer.step(x.shape[0])
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        times.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
    return dict(zip(("forward", "loss", "backward", "trainer_step"),
                    np.median(np.array(times), axis=0).tolist()))


def gluon_row(name, dtype, module_row):
    """One gluon row: ResNet-50 v1 hybridized at batch 32 under the
    policy ``dtype``, 2 warm and 20 timed steps synchronised by value,
    then one profiled step.  Fails on any check."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    gpu = mx.gpu(0)
    t0 = time.monotonic()
    batch = resnet_batch(RESNET_BATCH, gpu)
    x, y = batch.data[0], batch.label[0]
    net = gluon_resnet(gpu)
    trainer = gluon_trainer(net)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = net.collect_params()
    weight = params["resnetv10_conv2d0_weight"]
    losses = []

    def step():
        losses.append(gluon_step(net, trainer, loss_fn, x, y)._data.detach())

    def value_sync():
        # a value fetch: the last loss, and a scalar of an updated weight
        float(losses[-1][0])
        float(weight.data()._data.detach().view(-1)[0])

    for kern in KERNELS.values():
        kern.launches = 0
    with mx.amp.scope(dtype):
        step()  # traces the net under the policy, draws the weights
    value_sync()
    setup_s = time.monotonic() - t0
    aux0 = {n: p.data()._data.clone() for n, p in params.items()
            if p.grad_req == "null"}
    for _ in range(GLUON_WARM - 1):
        step()
    value_sync()
    t1 = time.monotonic()
    for _ in range(GLUON_STEPS):
        step()
    value_sync()
    wall = time.monotonic() - t1
    peak = torch.cuda.max_memory_allocated()
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    host = gluon_host_split(net, trainer, loss_fn, x, y)
    spans = device_spans(step)
    if not spans:
        fail("gluon %s: the profiler saw no device time in a step" % name)
    busy, window, heads = profile_summary(spans)
    idle, ops = 1 - busy / window, len(spans)
    timed = torch.stack([l.float().mean() for l in
                         losses[GLUON_WARM:GLUON_WARM + GLUON_STEPS]]).cpu()
    ms = wall / GLUON_STEPS * 1e3
    ips = GLUON_STEPS * RESNET_BATCH / wall
    log("[gluon] %s (%s): %d timed steps at batch %d (after %d warm): "
        "%.3f s (host clock, synchronised by value): %.3f ms a step, %.2f "
        "images/s; the Module per-step row of this run (phase resnet): "
        "%.3f ms, %.2f images/s; set-up and first step %.1f s"
        % (name, dtype or "fp32, TF32 off", GLUON_STEPS, RESNET_BATCH,
           GLUON_WARM, wall, ms, ips, module_row["ms"],
           module_row["imgs_per_sec"], setup_s))
    kinds = sorted(by_kind(spans).items(), key=lambda kv: -kv[1])
    log("[gluon] %s: one profiled step: device busy %.3f ms (Module %.3f), "
        "idle share at most %.3f (Module %.3f), %d device operations "
        "(Module %d); peak device memory %.1f MB allocated (Module %.1f); "
        "by kind: %s; most device time: %s"
        % (name, busy, module_row["busy_ms"], idle, module_row["idle"], ops,
           module_row["ops"], peak / 1e6, module_row["peak_mb"],
           "; ".join("%s %.3f ms" % (k, t / 1e3) for k, t in kinds),
           "; ".join("%s %.3f ms" % (n[:70], t / 1e3) for n, t in heads)))
    log("[gluon] %s: host ms a step by stage (median of 5 steps, no sync "
        "inside a step): %s; their sum %.3f ms"
        % (name, ", ".join("%s %.3f" % kv for kv in host.items()),
           sum(host.values())))
    log("[gluon] %s: the timed steps' mean losses: %s"
        % (name, " ".join("%.4f" % v for v in timed.tolist())))
    if not bool(torch.isfinite(timed).all()) or not timed[-1] < timed[0]:
        fail("gluon %s: losses not finite or not falling: %s"
             % (name, timed.tolist()))
    still = [n for n, a in aux0.items()
             if torch.equal(params[n].data()._data, a)]
    bad_var = [n for n in aux0 if n.endswith("_var")
               and not bool((params[n].data()._data > 0).all())]
    log("[gluon] %s: BN moving stats: %d of %d moved since the first step; "
        "flash-attention launches %s" % (name, len(aux0) - len(still),
                                         len(aux0), launches))
    if still or bad_var:
        fail("gluon %s: moving stats unmoved %s or non-positive %s"
             % (name, still[:3], bad_var[:3]))
    if any(launches.values()):
        fail("gluon %s: a flash-attention kernel launched: %s"
             % (name, launches))
    convs = {n for _, _, n in spans if kind_of(n) == "convolution"
             and "Nhwc" not in n and "Nchw" not in n}
    convs_bf16 = [n for n in convs if "bf16" in n or "bfloat16" in n]
    log("[gluon] %s: %d convolution kernels in the profiled step, %d of "
        "them bf16; the CachedOp's compute dtype %s"
        % (name, len(convs), len(convs_bf16), net._cached_op._amp_dtype))
    if bool(convs_bf16) != (dtype is not None) or \
            net._cached_op._amp_dtype != dtype:
        fail("gluon %s: %d bf16 convolution kernels, compute dtype %s, "
             "under %s" % (name, len(convs_bf16), net._cached_op._amp_dtype,
                           dtype or "fp32"))
    result = dict(ms=ms, imgs_per_sec=ips, busy_ms=busy, idle=idle, ops=ops,
                  peak_mb=peak / 1e6, launches=launches, host_ms=host)
    del net, trainer, losses, aux0, params, weight
    free_card()
    return result


def gluon_step_checks():
    """From one state, under cuDNN's deterministic algorithms: one
    hybridized Trainer step against one Module step (the traced graph
    under SoftmaxOutput, rescale_grad 1/batch), each group within
    ``GLUON_MODULE_TOL``; and one step of the same net not hybridized,
    which must equal the hybridized step bitwise."""
    free_card()
    gpu = mx.gpu(0)
    batch = resnet_batch(RESNET_BATCH, gpu, seed=1)
    x, y = batch.data[0], batch.label[0]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    net = gluon_resnet(gpu)
    with mx.autograd.pause():
        net(x)  # predict mode: draws the weights, leaves the moving stats
    start = {n: p.data()._data.clone()
             for n, p in net.collect_params().items()}
    torch.backends.cudnn.deterministic = True
    try:
        trainer = gluon_trainer(net)
        gluon_step(net, trainer, loss_fn, x, y)
        hybrid = gluon_state(net, trainer)
        del net, trainer
        imperative = gluon_resnet(gpu, hybridize=False)
        for n, p in imperative.collect_params().items():
            p.set_data(mx.nd.NDArray(start[n]))
        trainer = gluon_trainer(imperative)
        gluon_step(imperative, trainer, loss_fn, x, y)
        eager = gluon_state(imperative, trainer)
        del imperative, trainer
        mod = resnet_module(RESNET_BATCH, gpu)
        arg = set(mod.symbol.list_arguments())
        mod.init_params(
            arg_params={n: mx.nd.NDArray(t) for n, t in start.items()
                        if n in arg},
            aux_params={n: mx.nd.NDArray(t) for n, t in start.items()
                        if n not in arg})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.01, "momentum": 0.9})
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        g = mod._exec_group
        module = {"weights": {n: a[0]._data.clone() for n, a in
                              zip(g.param_names, g.param_arrays)},
                  "momenta": {g.param_names[i]: st._data.clone()
                              for i, st in mod._updater.states.items()
                              if st is not None},
                  "moving stats": {n: a[0]._data.clone() for n, a in
                                   zip(g.aux_names, g.aux_arrays)}}
        del mod
    finally:
        torch.backends.cudnn.deterministic = False
    vs_module = state_distance(hybrid, module)
    vs_eager = state_distance(eager, hybrid)
    log("[gluon] one Trainer step vs one Module step from the same state "
        "(batch %d, fp32, cuDNN deterministic; %d tensors), by group, the "
        "relative L2 and the tensors with the largest shares of it: %s; "
        "bounds %s" % (RESNET_BATCH, sum(len(v) for v in module.values()),
                       show_distance(vs_module), GLUON_MODULE_TOL))
    log("[gluon] the same step not hybridized vs hybridized: %s (bitwise "
        "equal wanted)" % show_distance(vs_eager))
    bad = [grp for grp, (rel, _) in vs_module.items()
           if not rel <= GLUON_MODULE_TOL[grp]]
    if bad or set(hybrid["weights"]) != set(module["weights"]):
        fail("gluon: the Trainer step is beyond the bound from the Module "
             "step in %s" % bad)
    if any(rel != 0 for rel, _ in vs_eager.values()):
        fail("gluon: the imperative step differs from the hybridized step")
    free_card()


class _FlashBlock(mx.gluon.HybridBlock):
    """Attention through the registered op, as a model would call it."""

    def __init__(self, causal, **kwargs):
        super().__init__(**kwargs)
        self._causal = causal

    def hybrid_forward(self, F, q, k, v):
        return F.contrib.flash_attention(q, k, v, causal=self._causal)


def gluon_attention_check():
    """The hybridized block under record() and backward at
    ``GLUON_ATTN`` bf16, causal and not: exactly one launch of each
    kernel a call, and the output and gradients against the plain
    versions at ``TOL``/``BWD_TOL`` and ``BF16_REL_L2`` (the plain
    backward on the backward kernels' inputs: the block's output and the
    plain LSE).  Returns each kernel's launches."""
    b, h, t, d = GLUON_ATTN
    gen = torch.Generator(device="cuda").manual_seed(2)
    total = {k: 0 for k in KERNELS}
    scale = d ** -0.5
    for causal in (True, False):
        q, k, v, g = (torch.randn(b * h, t, d, device="cuda", generator=gen)
                      .to(torch.bfloat16) for _ in range(4))
        args = [mx.nd.NDArray(a.view(b, h, t, d).clone()) for a in (q, k, v)]
        for a in args:
            a.attach_grad()
        blk = _FlashBlock(causal)
        blk.hybridize()
        for kern in KERNELS.values():
            kern.launches = 0
        with mx.autograd.record():
            out = blk(*args)
        out.backward(mx.nd.NDArray(g.view(b, h, t, d)))
        torch.cuda.synchronize()
        launches = {n: kern.launches for n, kern in KERNELS.items()}
        for n, c in launches.items():
            total[n] += c
        ref_o, ref_l, base = reference(q, k, v, scale, causal)
        got_o = out._data.detach().reshape(b * h, t, d)
        d_o = got_o.float() - ref_o.float()
        tol = TOL[torch.bfloat16]
        fwd = dict(err_over_tol=(d_o.abs() / (tol["atol"] + tol["rtol"]
                                              * base)).max().item(),
                   rel_l2=(d_o.norm() / ref_o.float().norm()).item())
        # the backward kernels' inputs: the block's output (delta is
        # rowsum(O * G)) and the LSE, which the kernel phase holds to the
        # plain version's within 2e-5 + 2e-4 of it
        ref, scales = backward_reference(q, k, v, g, got_o, ref_l, scale,
                                         causal)
        btol = BWD_TOL[torch.bfloat16]
        bwd = {}
        for gname, arr, want, sc in zip(("dq", "dk", "dv"), args, ref,
                                        scales):
            diff = arr.grad._data.reshape(b * h, t, d).float() - want.float()
            bwd[gname] = dict(
                err_over_tol=(diff.abs() / (btol["atol"] + btol["rtol"]
                                            * sc)).max().item(),
                rel_l2=(diff.norm() / want.float().norm()).item())
        log("[gluon] flash attention through a hybridized block at %s bf16 "
            "%s: launches %s; output %s; gradients %s"
            % (GLUON_ATTN, "causal" if causal else "not causal", launches,
               json.dumps(fwd), json.dumps(bwd)))
        if launches != {n: 1 for n in KERNELS}:
            fail("gluon attention: launches %s, want one of each"
                 % launches)
        if any(e["err_over_tol"] > 1.0 or e["rel_l2"] > BF16_REL_L2
               for e in [fwd] + list(bwd.values())):
            fail("gluon attention: disagrees with the plain version")
    return total


def phase_gluon(module_row):
    """The gluon rows, the step checks and the attention check; returns
    each path's kernel launches."""
    out = {name: gluon_row(name, dtype, module_row)
           for name, dtype in GLUON_ROWS}
    gluon_step_checks()
    out["gluon_attention"] = dict(launches=gluon_attention_check())
    return out


# BASELINE config #3 both ways (the ``lm`` phase).  (a) gluon word_lm at
# the medium configuration of Zaremba et al. 2014 (arXiv:1409.2329), as
# MXNet's example/gluon/word_language_model trains it on WikiText-2
# (--tied --nhid 650 --emsize 650 --dropout 0.5): vocabulary 33,278,
# 2 LSTM layers, bptt 35, batch 32, fp32; the recipe of
# examples/rnn/word_lm/train.py:104-125 (SGD lr 20, clip 0.25, the mean
# loss, states detached at each boundary), hybridized.
WORD_LM = dict(vocab=33278, width=650, layers=2, dropout=0.5)
WORD_LM_BPTT, WORD_LM_BATCH = 35, 32
WORD_LM_LR, WORD_LM_CLIP = 20.0, 0.25
WORD_LM_WARM, WORD_LM_STEPS, WORD_LM_EVAL = 2, 20, 4
# (b) example/rnn/bucketing/lstm_bucketing.py's defaults: 2 LSTMCell
# layers of 200, embedding 200, batch 32, buckets 10-60, a 10,000-word
# vocabulary (PTB's), SGD lr 0.01 (momentum 0), Xavier(in, 2.34); one
# epoch of BucketingModule.fit over enough synthetic sentences (lengths
# 5-60) that every bucket runs at least 3 batches
BUCKET_LM = dict(vocab=10000, hidden=200, embed=200, layers=2)
BUCKET_BATCH, BUCKETS, BUCKET_SENTENCES = 32, (10, 20, 30, 40, 50, 60), 1300
BUCKET_LR = 0.01
# the fused RNN op (cuDNN) against its plain loop on the card, f32, and
# raw nd calls against float64 (relative L2; PERF.md section 6 holds the
# predictions, written before the first run).  f32 sums in other orders
# read 1e-7 to 1e-6; TF32 rounds every product's inputs to 10 bits
# (2^-11 relative), which reads 1e-4 or more: each check also runs with
# TF32 on and must fail its bound there
RNN_OP_TOL = 5e-5
C4_TOL = 1e-5
# the word LM's step, card against the port's CPU f32 step (batch 2,
# dropout 0), and hybridized against not (batch 32): the loss and every
# gradient (relative L2).  The card's cuDNN RNN and the CPU's loop sum
# in other orders, as do the embedding's backward and the products;
# hybridized and not run the same kernels, but cuDNN's RNN weight
# gradients and the embedding's backward accumulate in no fixed order
LM_CPU_TOL = 1e-4
LM_HYBRID_TOL = 1e-5
# device operations by kind in the LM rows, first match wins
LM_KINDS = (("recurrence (cuDNN)", ("RNN", "LSTM", "Lstm", "lstm",
                                    "elemWise", "rnn_")),
            ("products", ("gemm", "Gemm", "xmma", "cutlass", "splitK")),
            ("embedding", ("embedding", "Embedding")),
            ("softmax and loss", ("softmax", "Softmax", "nll", "gather")),
            ("optimizer", ("multi_tensor_apply",)),
            ("reduction", ("reduce_kernel",)),
            ("copy and cast", ("direct_copy", "copy_kernel", "CatArray",
                               "Memcpy", "memcpy")),
            ("elementwise", ("elementwise",)))


class WordLM(mx.gluon.HybridBlock):
    """examples/rnn/word_lm/train.py's RNNModel: Embedding -> dropout ->
    LSTM -> dropout -> a Dense decoder tied to the embedding; the LSTM's
    input width is given, as the reference's model gives it (a
    hybridized parent cannot infer it)."""

    def __init__(self, vocab, width, layers, dropout, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.drop = mx.gluon.nn.Dropout(dropout)
            self.encoder = mx.gluon.nn.Embedding(vocab, width)
            self.rnn = mx.gluon.rnn.LSTM(width, num_layers=layers,
                                         dropout=dropout, input_size=width)
            self.decoder = mx.gluon.nn.Dense(vocab, flatten=False,
                                             params=self.encoder.params)

    def hybrid_forward(self, F, x, states):
        emb = self.drop(self.encoder(x))
        out, states = self.rnn(emb, states)
        return self.decoder(self.drop(out)), states


def markov_stream(n, vocab, seed=0):
    """examples/rnn/word_lm/train.py:42-49's synthetic corpus: the next
    token (7 t + 3) mod vocab with probability 0.85, else uniform."""
    rng = np.random.RandomState(seed)
    toks = [rng.randint(1, vocab)]
    for _ in range(n - 1):
        toks.append((toks[-1] * 7 + 3) % vocab if rng.rand() < 0.85
                    else rng.randint(0, vocab))
    return np.array(toks, np.float32)


def word_lm_net(ctx, dropout=WORD_LM["dropout"], hybridize=True):
    """The word LM at WORD_LM's widths on ``ctx``, built in a fresh
    NameManager, gluon's default initializer after ``random.seed(0)``."""
    with mx.sym.NameManager():
        net = WordLM(**dict(WORD_LM, dropout=dropout))
    mx.random.seed(0)
    net.initialize(ctx=ctx)
    if hybridize:
        net.hybridize()
    return net


def word_lm_trainable(net):
    return [p for p in net.collect_params().values() if p.grad_req != "null"]


def word_lm_step(net, trainer, loss_fn, x, y, states, stages=None):
    """One step of the example's recipe: the states detached, the mean
    loss under record(), backward, clip_global_norm, Trainer.step(1).
    With ``stages`` (a list), the host clock before the step and after
    each stage is appended to it."""
    mark = stages.append if stages is not None else (lambda t: None)
    states = [s.detach() for s in states]
    mark(time.perf_counter())
    with mx.autograd.record():
        logits, states = net(x, states)
        mark(time.perf_counter())
        loss = loss_fn(logits, y).mean()
        mark(time.perf_counter())
    loss.backward()
    mark(time.perf_counter())
    mx.gluon.utils.clip_global_norm(
        [p.grad() for p in word_lm_trainable(net)], WORD_LM_CLIP)
    mark(time.perf_counter())
    trainer.step(1)
    mark(time.perf_counter())
    return loss, states


def word_lm_batches(ctx, batch, steps, seed=0):
    """(x, y) pairs of bptt x batch tokens on ``ctx``: the example's
    batchify of the Markov stream (one column a sequence)."""
    n = (WORD_LM_BPTT * steps + 1) * batch
    data = markov_stream(n, WORD_LM["vocab"], seed).reshape(batch, -1).T
    data = mx.nd.array(np.ascontiguousarray(data), ctx=ctx)
    return [(mx.nd.NDArray(data._data[i:i + WORD_LM_BPTT]),
             mx.nd.NDArray(data._data[i + 1:i + 1 + WORD_LM_BPTT]))
            for i in range(0, steps * WORD_LM_BPTT, WORD_LM_BPTT)]


def word_lm_zero_states(ctx, batch):
    shape = (WORD_LM["layers"], batch, WORD_LM["width"])
    return [mx.nd.zeros(shape, ctx=ctx) for _ in range(2)]


def word_lm_gflop_per_step():
    """(decoder, LSTM) GFLOP of one step, forward and backward (three
    products a matrix product): the decoder's (1120 x 650) x (650 x
    33,278), the LSTM's input and recurrent products."""
    t = WORD_LM_BPTT * WORD_LM_BATCH
    v, w, layers = WORD_LM["vocab"], WORD_LM["width"], WORD_LM["layers"]
    return 3 * 2 * t * w * v / 1e9, 3 * 2 * t * layers * 8 * w * w / 1e9


def word_lm_row():
    """The gluon word LM on the card: 2 warm and 20 timed steps, states
    carried and detached, synchronised by value; the host's split of 5
    steps; one profiled step; one evaluation pass without record().
    Fails on any check; returns the row's numbers and the kernels'
    launches."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    gpu = mx.gpu(0)
    t0 = time.monotonic()
    net = word_lm_net(gpu)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": WORD_LM_LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    n_train = WORD_LM_WARM + WORD_LM_STEPS + 6
    batches = word_lm_batches(gpu, WORD_LM_BATCH, n_train + WORD_LM_EVAL)
    train, held_out = batches[:n_train], batches[n_train:]
    states = word_lm_zero_states(gpu, WORD_LM_BATCH)
    weight = word_lm_trainable(net)[0]
    losses = []
    for kern in KERNELS.values():
        kern.launches = 0

    def value_sync():
        float(losses[-1])
        float(weight.data()._data.detach().view(-1)[0])

    for x, y in train[:WORD_LM_WARM]:
        loss, states = word_lm_step(net, trainer, loss_fn, x, y, states)
        losses.append(loss._data.detach())
    value_sync()
    setup_s = time.monotonic() - t0
    t1 = time.monotonic()
    for x, y in train[WORD_LM_WARM:WORD_LM_WARM + WORD_LM_STEPS]:
        loss, states = word_lm_step(net, trainer, loss_fn, x, y, states)
        losses.append(loss._data.detach())
    value_sync()
    wall = time.monotonic() - t1
    peak = torch.cuda.max_memory_allocated()
    host = []
    for x, y in train[WORD_LM_WARM + WORD_LM_STEPS:-1]:
        stages = []
        _, states = word_lm_step(net, trainer, loss_fn, x, y, states,
                                 stages)
        torch.cuda.synchronize()
        host.append(np.diff(stages) * 1e3)
    host = dict(zip(("forward", "loss", "backward", "clip_global_norm",
                     "trainer_step"), np.median(host, axis=0).tolist()))
    x, y = train[-1]
    spans = device_spans(lambda: word_lm_step(net, trainer, loss_fn, x, y,
                                              states))
    if not spans:
        fail("word_lm_gluon: the profiler saw no device time in a step")
    busy, window, heads = profile_summary(spans, top=10)
    eval_losses = []
    eval_states = word_lm_zero_states(gpu, WORD_LM_BATCH)
    for x, y in held_out:
        logits, eval_states = net(x, eval_states)
        eval_losses.append(float(loss_fn(logits, y).mean()))
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    timed = torch.stack(losses[WORD_LM_WARM:]).cpu().numpy()
    ms = wall / WORD_LM_STEPS * 1e3
    tokens = WORD_LM_BPTT * WORD_LM_BATCH
    dec, lstm = word_lm_gflop_per_step()
    bound, bound_by = bound_ms(0, (dec + lstm) * 1e9, torch.float32)
    kinds = sorted(by_kind(spans, LM_KINDS).items(), key=lambda kv: -kv[1])
    log("[lm] word_lm_gluon (vocabulary %d, %d x %d LSTM, tied, dropout "
        "%.1f, bptt %d, batch %d, fp32, TF32 off, hybridized): %d timed "
        "steps after %d warm: %.3f s (host clock, synchronised by value): "
        "%.3f ms a step, %.1f tokens/s; set-up and warm steps %.1f s; "
        "peak device memory %.1f MB allocated"
        % (WORD_LM["vocab"], WORD_LM["layers"], WORD_LM["width"],
           WORD_LM["dropout"], WORD_LM_BPTT, WORD_LM_BATCH, WORD_LM_STEPS,
           WORD_LM_WARM, wall, ms, tokens / ms * 1e3, setup_s, peak / 1e6))
    log("[lm] word_lm_gluon: one profiled step: device busy %.3f ms, idle "
        "share at most %.3f, %d device operations; %.1f GFLOP a step "
        "(decoder %.1f, LSTM %.1f), bound %.3f ms (%s, 67 TFLOP/s fp32); "
        "by kind: %s; most device time: %s"
        % (busy, 1 - busy / window, len(spans), dec + lstm, dec, lstm,
           bound, bound_by,
           "; ".join("%s %.3f ms" % (k, t / 1e3) for k, t in kinds),
           "; ".join("%s %.3f ms" % (n[:80], t / 1e3) for n, t in heads)))
    log("[lm] word_lm_gluon: host ms a step by stage (median of 5 steps, "
        "a sync after each step; clip_global_norm syncs once an array, "
        "so it also waits for the backward's device work): %s; their sum "
        "%.3f ms" % (", ".join("%s %.3f" % kv for kv in host.items()),
                     sum(host.values())))
    log("[lm] word_lm_gluon: the timed steps' losses: %s; evaluation over "
        "%d held-out batches without record(): mean loss %.4f, perplexity "
        "%.1f; flash-attention launches %s"
        % (" ".join("%.4f" % v for v in timed), len(held_out),
           np.mean(eval_losses), np.exp(np.mean(eval_losses)), launches))
    if not (np.isfinite(timed).all() and np.isfinite(eval_losses).all()):
        fail("word_lm_gluon: a loss is not finite")
    if not timed[-5:].mean() < timed[:5].mean():
        fail("word_lm_gluon: the losses do not fall: %s" % timed.tolist())
    if any(launches.values()):
        fail("word_lm_gluon: a flash-attention kernel launched: %s"
             % launches)
    result = dict(ms=ms, tokens_per_sec=tokens / ms * 1e3, busy_ms=busy,
                  idle=1 - busy / window, ops=len(spans), peak_mb=peak / 1e6,
                  bound_ms=bound, host_ms=host, launches=launches)
    del net, trainer, weight, train, held_out, states, batches
    free_card()
    return result


def rel_l2(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def rnn_op_case(mode, shape, hidden, layers, bidirectional, gen):
    """Inputs of the RNN op (data, flat parameters, states, cells or
    None) and cotangents of its outputs, on the card."""
    t, n, c = shape
    d = 2 if bidirectional else 1
    size = mx.ops.rnn_op.rnn_param_size(c, hidden, layers, bidirectional,
                                        mode)

    def randn(*s):
        return torch.randn(*s, device="cuda", generator=gen)

    weights = 0.07 * (2 * torch.rand(size, device="cuda", generator=gen)
                      - 1)
    inputs = [randn(t, n, c), weights, 0.5 * randn(layers * d, n, hidden),
              0.5 * randn(layers * d, n, hidden) if mode == "lstm"
              else None]
    heads = [randn(t, n, d * hidden), randn(layers * d, n, hidden),
             randn(layers * d, n, hidden)]
    return inputs, heads


def rnn_op_run(fn, mode, inputs, heads, hidden, layers, bidirectional):
    """fn (rnn_fused or rnn_plain): the outputs and the gradients with
    respect to every input."""
    leaves = [None if a is None else a.detach().clone().requires_grad_()
              for a in inputs]
    outs = [o for o in fn(*leaves, hidden, layers, bidirectional, mode)
            if o is not None]
    grads = torch.autograd.grad(outs, [a for a in leaves if a is not None],
                                heads[:len(outs)])
    return [o.detach() for o in outs], list(grads)


def library_lstm_ms(inputs, heads):
    """torch.nn.LSTM's forward and backward (device ms) at the LSTM
    case's weights, inputs and cotangents: the yardstick."""
    lib = torch.nn.LSTM(650, 650, num_layers=2).cuda()
    ws, bs = mx.ops.rnn_op._unpack_params(inputs[1], 650, 650, 2, False,
                                          "lstm")
    with torch.no_grad():
        for i in range(2):
            for name, v in zip(("weight_ih", "weight_hh", "bias_ih",
                                "bias_hh"), ws[i][0] + bs[i][0]):
                getattr(lib, "%s_l%d" % (name, i)).copy_(v)

    def run():
        x = inputs[0].detach().clone().requires_grad_()
        out, (h, c) = lib(x, (inputs[2], inputs[3]))
        torch.autograd.backward([out, h, c], heads)

    return device_ms(run, 3)


def rnn_op_check():
    """The fused RNN op (cuDNN, a call per layer) against its plain
    loop on the card, f32: at the word LM's shape (35, 32, 650), 2
    LSTM layers, dropout 0, and a bidirectional 2-layer GRU at (12, 4,
    24) x 16; the outputs, final states and the gradients with respect
    to data, parameters and states within RNN_OP_TOL, and beyond it
    with TF32 on.  Returns (the worst error, device ms of the LSTM
    case's forward and backward: cuDNN, the plain loop,
    torch.nn.LSTM)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    op = mx.ops.rnn_op
    worst, times = 0.0, None
    # the plain loop's products are called directly, not through an op
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for mode, shape, hidden, bi in (("lstm", (35, 32, 650), 650, False),
                                    ("gru", (12, 4, 24), 16, True)):
        inputs, heads = rnn_op_case(mode, shape, hidden, 2, bi, gen)
        args = (mode, inputs, heads, hidden, 2, bi)
        plain = rnn_op_run(op.rnn_plain, *args)
        fused = rnn_op_run(op.rnn_fused, *args)
        with tf32_on():
            tf32 = rnn_op_run(op.rnn_fused, *args)
        names = ["out", "h", "c"][:len(plain[0])] + [
            "d_" + n for n in ("data", "params", "h0", "c0")][
                :len(plain[1])]
        want = plain[0] + plain[1]
        errs = dict(zip(names, [rel_l2(a, b) for a, b in
                                zip(fused[0] + fused[1], want)]))
        errs_tf32 = dict(zip(names, [rel_l2(a, b) for a, b in
                                     zip(tf32[0] + tf32[1], want)]))
        log("[lm] RNN op %s %s x %d, 2 layers%s: cuDNN vs the plain loop "
            "(relative L2, bound %g): %s; with TF32 on: %s"
            % (mode, shape, hidden, ", bidirectional" if bi else "",
               RNN_OP_TOL, json.dumps({k: float("%.3g" % v)
                                       for k, v in errs.items()}),
               json.dumps({k: float("%.3g" % v)
                           for k, v in errs_tf32.items()})))
        if max(errs.values()) > RNN_OP_TOL:
            fail("RNN op %s: cuDNN disagrees with the plain loop" % mode)
        if max(errs_tf32.values()) <= RNN_OP_TOL:
            fail("RNN op %s: TF32 reads within the bound, which then does "
                 "not tell float32 from TF32" % mode)
        worst = max(worst, max(errs.values()))
        if mode == "lstm":
            times = {name: device_ms(lambda f=f: rnn_op_run(f, *args), 3)
                     for name, f in (("cudnn", op.rnn_fused),
                                     ("plain", op.rnn_plain))}
            times["library"] = library_lstm_ms(inputs, heads)
    return worst, times


def c4_check():
    """ROADMAP C4: raw nd.Convolution at ResNet's first layer, raw
    nd.FullyConnected and nd.RNN at the word LM's shapes, and the
    products of the op corpus (``dot``, ``batch_dot``, ``einsum``,
    ``_onnx_MatMul``) at attention-like shapes, called after the process
    set both TF32 flags on, each against the same op in float64 within
    C4_TOL; the same calls with the ops' TF32 rule taken out must fail
    it."""
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(*s):
        return torch.rand(*s, device="cuda", generator=gen)

    def randn(*s):
        return torch.randn(*s, device="cuda", generator=gen)

    t, n, w, v = WORD_LM_BPTT, WORD_LM_BATCH, WORD_LM["width"], \
        WORD_LM["vocab"]
    size = mx.ops.rnn_op.rnn_param_size(w, w, 2, False, "lstm")
    cases = {
        "Convolution": ([rand(32, 3, 224, 224), 0.1 * randn(64, 3, 7, 7),
                         0.1 * randn(64)],
                        dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                             num_filter=64)),
        "FullyConnected": ([randn(t * n, w), 0.07 * (2 * rand(v, w) - 1),
                            0.1 * randn(v)], dict(num_hidden=v)),
        "RNN": ([randn(t, n, w), 0.07 * (2 * rand(size) - 1),
                 0.5 * randn(2, n, w), 0.5 * randn(2, n, w)],
                dict(state_size=w, num_layers=2, mode="lstm")),
        "dot": ([randn(256, 512), randn(512, 256)], {}),
        "batch_dot": ([randn(8, 128, 512), randn(8, 256, 512)],
                      dict(transpose_b=True)),
        "einsum": ([randn(8, 128, 512), randn(8, 512, 128)],
                   dict(subscripts="bij,bjk->bik")),
        "_onnx_MatMul": ([randn(8, 128, 512), randn(512, 128)], {}),
    }
    errs = {}
    for name, (args, attrs) in cases.items():
        fn = getattr(mx.nd, name)
        want = fn(*[mx.nd.NDArray(a.double()) for a in args], **attrs)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        got = fn(*[mx.nd.NDArray(a) for a in args], **attrs)
        with tf32_on():
            tf32 = fn(*[mx.nd.NDArray(a) for a in args], **attrs)
        errs[name] = (rel_l2(got._data, want._data),
                      rel_l2(tf32._data, want._data))
    log("[lm] C4, raw nd calls in float32 after the process set TF32 on, "
        "against float64 (relative L2, bound %g): %s; the same calls with "
        "TF32 left on: %s" % (C4_TOL, json.dumps(
            {k: float("%.3g" % e[0]) for k, e in errs.items()}),
            json.dumps({k: float("%.3g" % e[1]) for k, e in errs.items()})))
    bad = [k for k, (f32, _) in errs.items() if not f32 <= C4_TOL]
    blind = [k for k, (_, tf32) in errs.items() if tf32 <= C4_TOL]
    if bad:
        fail("C4: %s beyond the bound with the flags set on" % bad)
    if blind:
        fail("C4: %s with TF32 within the bound, which then does not tell "
             "float32 from TF32" % blind)
    return errs


def word_lm_grads(net, x, y, batch, ctx):
    """One recorded step's mean loss and every gradient (no update)."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        logits, _ = net(x, word_lm_zero_states(ctx, batch))
        loss = loss_fn(logits, y).mean()
    loss.backward()
    return loss._data.detach().double().cpu(), {
        p.name: p.grad()._data.detach().double().cpu()
        for p in word_lm_trainable(net)}


def grads_distance(a, b):
    """(the loss's relative error, the worst parameter's gradient
    relative L2, its name) of two word_lm_grads results."""
    per = {k: rel_l2(a[1][k], b[1][k]) for k in b[1]}
    worst = max(per, key=per.get)
    return rel_l2(a[0], b[0]), per[worst], worst


def word_lm_checks():
    """With dropout 0: one step at batch 2 on the card against the
    port's CPU f32 step from the same weights (within LM_CPU_TOL), and
    one step at batch 32 hybridized against the same step not
    hybridized (within LM_HYBRID_TOL)."""
    free_card()
    gpu, cpu = mx.gpu(0), mx.cpu()
    card = word_lm_net(gpu, dropout=0.0)
    weights = {k: p.data().asnumpy()
               for k, p in card.collect_params().items()}
    x, y = word_lm_batches(cpu, 2, 1, seed=1)[0]
    xg, yg = x.as_in_context(gpu), y.as_in_context(gpu)
    on_card = word_lm_grads(card, xg, yg, 2, gpu)
    host = word_lm_net(cpu, dropout=0.0)
    mx.gluon.parameter.load_numpy(host.collect_params(), weights)
    on_cpu = word_lm_grads(host, x, y, 2, cpu)
    with tf32_on():
        tf32 = word_lm_grads(card, xg, yg, 2, gpu)
    vs_cpu = grads_distance(on_card, on_cpu)
    vs_cpu_tf32 = grads_distance(tf32, on_cpu)
    del host
    x, y = word_lm_batches(gpu, WORD_LM_BATCH, 1, seed=2)[0]
    hybrid = word_lm_grads(card, x, y, WORD_LM_BATCH, gpu)
    eager_net = word_lm_net(gpu, dropout=0.0, hybridize=False)
    mx.gluon.parameter.load_numpy(eager_net.collect_params(), weights)
    eager = word_lm_grads(eager_net, x, y, WORD_LM_BATCH, gpu)
    vs_eager = grads_distance(eager, hybrid)
    log("[lm] word LM, one step at batch 2 (dropout 0), card vs the CPU "
        "f32 step from the same weights: loss %.3g, worst gradient %.3g "
        "(%s) (relative; bound %g); with TF32 on: loss %.3g, worst "
        "gradient %.3g (%s)" % (vs_cpu + (LM_CPU_TOL,) + vs_cpu_tf32))
    log("[lm] word LM, one step at batch %d (dropout 0) on the card, not "
        "hybridized vs hybridized: loss %.3g, worst gradient %.3g (%s) "
        "(relative; bound %g)" % ((WORD_LM_BATCH,) + vs_eager
                                  + (LM_HYBRID_TOL,)))
    if not max(vs_cpu[:2]) <= LM_CPU_TOL:
        fail("word LM: the card's step disagrees with the CPU step")
    if not max(vs_eager[:2]) <= LM_HYBRID_TOL:
        fail("word LM: the imperative step disagrees with the hybridized "
             "step")
    del card, eager_net
    free_card()
    return vs_cpu, vs_eager


def synthetic_sentences(n, vocab, seed=0):
    """lstm_bucketing.py:26-38's synthetic sentences at lengths 5-60:
    the next token (3 t + 1) mod vocab with probability 0.9, else
    uniform."""
    rng = np.random.RandomState(seed)
    sents = []
    for _ in range(n):
        toks = [rng.randint(1, vocab)]
        for _ in range(rng.randint(5, 61) - 1):
            toks.append((toks[-1] * 3 + 1) % vocab if rng.rand() < 0.9
                        else rng.randint(1, vocab))
        sents.append(toks)
    return sents


def bucket_sym_gen(seq_len):
    """lstm_bucketing.py's sym_gen: Embedding -> 2 LSTMCells unrolled
    over the bucket -> FullyConnected -> SoftmaxOutput."""
    cfg = BUCKET_LM
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data=data, input_dim=cfg["vocab"],
                             output_dim=cfg["embed"], name="embed")
    stack = mx.rnn.SequentialRNNCell()
    for i in range(cfg["layers"]):
        stack.add(mx.rnn.LSTMCell(num_hidden=cfg["hidden"],
                                  prefix="lstm_l%d_" % i))
    outputs, _ = stack.unroll(seq_len, inputs=embed, layout="NTC",
                              merge_outputs=True, batch_size=BUCKET_BATCH)
    pred = mx.sym.Reshape(outputs, shape=(-1, cfg["hidden"]))
    pred = mx.sym.FullyConnected(data=pred, num_hidden=cfg["vocab"],
                                 name="pred")
    label = mx.sym.Reshape(data=label, shape=(-1,))
    return (mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax"),
            ("data",), ("softmax_label",))


def bucket_batch(key, ctx, seed):
    """One batch of bucket ``key`` (sentences of key - 9 to key
    tokens) from the synthetic sentences, as the iterator pads it."""
    sents = [s for s in synthetic_sentences(400, BUCKET_LM["vocab"], seed)
             if key - 9 <= len(s) <= key]
    random.seed(seed)  # the iterator shuffles with the global generators
    np.random.seed(seed)
    it = mx.rnn.BucketSentenceIter(sents, BUCKET_BATCH, buckets=[key],
                                   invalid_label=0, ctx=ctx)
    return next(it)


def bucketing_row():
    """lstm_bucketing.py on the card: one epoch of BucketingModule.fit
    over the synthetic sentences, Perplexity(ignore_label=0) and a
    Speedometer; then one profiled step at bucket 60, the buckets'
    sharing, and one step at bucket 10 against the CPU's.  Fails on any
    check."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    sents = synthetic_sentences(BUCKET_SENTENCES, BUCKET_LM["vocab"])
    random.seed(0)
    np.random.seed(0)
    it = mx.rnn.BucketSentenceIter(sents, BUCKET_BATCH, buckets=BUCKETS,
                                   invalid_label=0)
    per_bucket = {b: sum(1 for i, _ in it.idx if BUCKETS[i] == b)
                  for b in BUCKETS}
    if min(per_bucket.values()) < 3:
        fail("lstm_bucketing: a bucket has fewer than 3 batches: %s"
             % per_bucket)
    mod = mx.mod.BucketingModule(bucket_sym_gen, default_bucket_key=60)
    for kern in KERNELS.values():
        kern.launches = 0
    record = []
    clock = [time.perf_counter()]

    def recorder(param):
        """After each batch (the metric's update has synchronised):
        its bucket, wall ms, real tokens and both perplexities; then the
        metric starts anew."""
        now = time.perf_counter()
        batch = param.locals["data_batch"]
        values = dict(param.eval_metric.get_name_value())
        record.append((batch.bucket_key, (now - clock[0]) * 1e3,
                       int((batch.label[0]._data != 0).sum()),
                       values["perplexity"], values["perplexity_all"]))
        clock[0] = now
        param.eval_metric.reset()

    mx.random.seed(0)
    logging.basicConfig(level=logging.INFO)  # the Speedometer's lines
    mod.fit(it, eval_metric=[mx.metric.Perplexity(ignore_label=0),
                             mx.metric.Perplexity(name="perplexity_all")],
            optimizer="sgd", optimizer_params={"learning_rate": BUCKET_LR},
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=1, batch_end_callback=[
                mx.callback.Speedometer(BUCKET_BATCH, 10, auto_reset=False),
                recorder])
    fit_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    # ms a batch by bucket, leaving out each bucket's first (its bind)
    seen, steady = set(), []
    for rec in record:
        if rec[0] in seen:
            steady.append(rec)
        seen.add(rec[0])
    by_bucket = {b: float(np.median([r[1] for r in steady if r[0] == b]))
                 for b in BUCKETS}
    steady_s = sum(r[1] for r in steady) / 1e3
    positions = sum(BUCKET_BATCH * r[0] for r in steady) / steady_s
    real = sum(r[2] for r in steady) / steady_s
    ppl = np.array([r[3] for r in record])
    ppl_all = np.array([r[4] for r in record])
    batch60 = bucket_batch(60, mx.gpu(0), seed=3)

    def step60():
        mod.forward(batch60, is_train=True)
        mod.backward()
        mod.update()

    step60()
    spans = device_spans(step60)
    if not spans:
        fail("lstm_bucketing: the profiler saw no device time in a step")
    busy, window, heads = profile_summary(spans, top=8)
    kinds = sorted(by_kind(spans, LM_KINDS).items(), key=lambda kv: -kv[1])
    n_nodes = len(bucket_sym_gen(60)[0]._topo())
    host = bucketing_host_split(mod, batch60)
    log("[lm] lstm_bucketing (vocabulary %d, 2 x %d LSTMCell unrolled, "
        "embedding %d, batch %d, buckets %s, SGD lr %g, fp32, TF32 off): "
        "one epoch of BucketingModule.fit, %d batches %s, in %.1f s with "
        "the binds; %d executors bound; ms a batch by bucket (median after "
        "its first): %s; %.1f positions/s and %.1f real tokens/s over the "
        "batches after each bucket's first; peak device memory %.1f MB "
        "allocated" % (BUCKET_LM["vocab"], BUCKET_LM["hidden"],
                       BUCKET_LM["embed"], BUCKET_BATCH, list(BUCKETS),
                       BUCKET_LR, len(record), per_bucket, fit_s,
                       len(mod._buckets), json.dumps(
                           {b: round(v, 3) for b, v in by_bucket.items()}),
                       positions, real, peak / 1e6))
    log("[lm] lstm_bucketing: one profiled step at bucket 60 (%d graph "
        "nodes): device busy %.3f ms, idle share at most %.3f, %d device "
        "operations; by kind: %s; most device time: %s"
        % (n_nodes, busy, 1 - busy / window, len(spans),
           "; ".join("%s %.3f ms" % (k, t / 1e3) for k, t in kinds),
           "; ".join("%s %.3f ms" % (n[:80], t / 1e3) for n, t in heads)))
    log("[lm] lstm_bucketing: host ms a step at bucket 60 by stage "
        "(median of 3 steps, a sync after each step; the metric's update "
        "waits for the step's device work): %s; their sum %.3f ms; the "
        "forward %.1f us a graph node"
        % (", ".join("%s %.3f" % kv for kv in host.items()),
           sum(host.values()), host["forward"] * 1e3 / n_nodes))
    log("[lm] lstm_bucketing: perplexity a batch, real tokens "
        "(ignore_label=0): %s; over every label the SoftmaxOutput trains "
        "on (padding included): %s; flash-attention launches %s"
        % (" ".join("%.0f" % v for v in ppl),
           " ".join("%.0f" % v for v in ppl_all), launches))
    if not (np.isfinite(ppl).all() and np.isfinite(ppl_all).all()):
        fail("lstm_bucketing: a perplexity is not finite")
    if not ppl_all[-5:].mean() < ppl_all[:5].mean():
        fail("lstm_bucketing: the trained perplexity does not fall")
    if any(launches.values()):
        fail("lstm_bucketing: a flash-attention kernel launched: %s"
             % launches)
    if len(mod._buckets) != len(BUCKETS):
        fail("lstm_bucketing: %d executors bound" % len(mod._buckets))
    bucketing_sharing(mod)
    bucketing_cpu_check(mod)
    result = dict(ms_by_bucket=by_bucket, positions_per_sec=positions,
                  tokens_per_sec=real, busy_ms=busy, idle=1 - busy / window,
                  ops=len(spans), nodes=n_nodes, peak_mb=peak / 1e6,
                  host_ms=host, launches=launches)
    del mod, it
    free_card()
    return result


def bucketing_host_split(mod, batch, steps=3):
    """The host's ms in a step's forward, backward, update and the
    metric's update: the host clock around each call, a sync after each
    step, the median over ``steps``."""
    metric = mx.metric.Perplexity(ignore_label=0)
    times = []
    for _ in range(steps):
        t = [time.perf_counter()]
        mod.forward(batch, is_train=True)
        t.append(time.perf_counter())
        mod.backward()
        t.append(time.perf_counter())
        mod.update()
        t.append(time.perf_counter())
        mod.update_metric(metric, batch.label)
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        times.append(np.diff(t) * 1e3)
    return dict(zip(("forward", "backward", "update", "metric"),
                    np.median(times, axis=0).tolist()))


def bucketing_sharing(mod):
    """Every bucket's executor holds the default bucket's tensors, one
    per parameter name (and one gradient), and every bucket's Module
    the default's optimizer, updater and states."""
    default = mod.default_module
    ptrs = {}
    for m in mod._buckets.values():
        ex = m._exec_group.execs[0]
        for name in m._exec_group.param_names:
            ptrs.setdefault(name, set()).add(
                (ex.arg_dict[name]._data.data_ptr(),
                 ex.grad_dict[name]._data.data_ptr()))
    shared_opt = all(m._updater is default._updater and
                     m._optimizer is default._optimizer
                     for m in mod._buckets.values())
    log("[lm] lstm_bucketing: %d parameters across %d executors, tensors "
        "a name %s; one optimizer and updater: %s; %d optimizer states"
        % (len(ptrs), len(mod._buckets),
           sorted({len(v) for v in ptrs.values()}), shared_opt,
           len(default._updater.states)))
    if any(len(v) != 1 for v in ptrs.values()) or not shared_opt:
        fail("lstm_bucketing: the buckets do not share their parameters "
             "and optimizer")


def bucketing_cpu_check(mod):
    """One step at bucket 10 from the trained weights: the card's Module
    against the port's CPU Module (the output and every gradient,
    relative L2 within LM_CPU_TOL)."""
    arg, _ = mod.get_params()
    weights = {k: v.asnumpy() for k, v in arg.items()}
    results = {}
    for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        sym, data_names, label_names = bucket_sym_gen(10)
        m = mx.mod.Module(sym, data_names, label_names, context=ctx)
        batch = bucket_batch(10, ctx, seed=4)
        m.bind(batch.provide_data, batch.provide_label)
        m.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                  for k, v in weights.items()})
        m.forward(batch, is_train=True)
        m.backward()
        g = m._exec_group
        results[name] = ({n: a[0]._data.detach().double().cpu()
                          for n, a in zip(g.param_names, g.grad_arrays)},
                         m.get_outputs()[0]._data.detach().double().cpu())
    per = {k: rel_l2(results["card"][0][k], v)
           for k, v in results["cpu"][0].items()}
    worst = max(per, key=per.get)
    out = rel_l2(results["card"][1], results["cpu"][1])
    log("[lm] lstm_bucketing: one step at bucket 10, card vs CPU f32 from "
        "the same weights: output %.3g, worst gradient %.3g (%s) "
        "(relative L2; bound %g)" % (out, per[worst], worst, LM_CPU_TOL))
    if not max(out, per[worst]) <= LM_CPU_TOL:
        fail("lstm_bucketing: the card's step disagrees with the CPU step")


def phase_lm():
    """C4's check, the RNN op's check, the two LSTM LM rows and their
    checks; returns each row's numbers (with its kernel launches)."""
    t0 = time.monotonic()
    c4_check()
    op_err, op_ms = rnn_op_check()
    gluon = word_lm_row()
    word_lm_checks()
    bucketing = bucketing_row()
    log("[lm] the RNN op at (35, 32, 650) x 2 layers, forward and "
        "backward, device ms: cuDNN %.3f, the plain loop %.3f, "
        "torch.nn.LSTM %.3f; the phase took %.1f s"
        % (op_ms["cudnn"], op_ms["plain"], op_ms["library"],
           time.monotonic() - t0))
    return {"word_lm_gluon": gluon, "lstm_bucketing": bucketing}


# ---------------------------------------------------------------------------
# sparse: BASELINE config #5, sparse linear classification
# ---------------------------------------------------------------------------

# the Avazu-app set's feature count (LIBSVM datasets), which the reference
# example/sparse/linear_classification trains on; its ~14.6 M rows cut to
# 65,536 (8 batches an epoch); the reference train.py's batch
SPARSE_FEATURES, SPARSE_DATA_ROWS, SPARSE_BATCH = 1_000_000, 65_536, 8192
SPARSE_EPOCHS = 2
# (row, optimizer, learning rate, kvstore): AdaGrad at the example's lr
# 0.1; SGD at 0.1 x batch, the reference's step (its loss is summed
# before rescale_grad = 1 / batch, the example's is averaged as well)
SPARSE_ROWS = (("linear_cls_adagrad", "adagrad", 0.1, None),
               ("linear_cls_sgd", "sgd", 0.1 * SPARSE_BATCH, None),
               ("linear_cls_kvlocal", "adagrad", 0.1, "local"))
SPARSE_SPLIT = 5            # batches in the host's split
# one AdaGrad step on the card against the port's CPU step: the touched
# weights (absolute) and history (relative to its largest value); the
# card's index_add_ sums in no fixed order
SPARSE_CPU_TOL = {"weight": 1e-6, "history": 1e-4}
# the sparse products against the dense product of the densified CSR
# (TF32 off), relative L2, on the first SPARSE_DOT_ROWS rows
SPARSE_DOT_TOL, SPARSE_DOT_ROWS = 1e-5, 512
# tests/test_sparse.py:223-258's sizes: a 128 MB table
EMBED = dict(vocab=1_000_000, dim=32, ids=512, lr=0.1)
EMBED_WARM, EMBED_STEPS = 2, 20
EMBED_TOL = 1e-6            # the sparse step against the dense step
SPARSE_KINDS = (("gather and scatter", ("index", "scatter", "gather",
                                        "embedding", "Embedding")),
                ("sort and unique", ("sort", "Sort", "unique", "radix",
                                     "Radix", "scan", "Scan")),
                ("reduction", ("reduce_kernel",)),
                ("copy and fill", ("copy", "Memcpy", "Memset", "fill")),
                ("elementwise", ("elementwise",)))
EXAMPLE = Path(__file__).resolve().parent / "examples" / "sparse" / \
    "linear_classification.py"


_SPARSE_DATA = {}


def sparse_data(ex):
    """(directory, path, seconds): the example's ``synthesize()`` at
    SPARSE_DATA_ROWS x SPARSE_FEATURES (seed 0), written once a run
    under the name the example's ``main()`` looks for in
    ``MXTPU_DATA_DIR``, so that the dist phase's workers read the sparse
    phase's file; removed when the run ends."""
    if not _SPARSE_DATA:
        d = tempfile.mkdtemp(prefix="chip_smoke_data_")
        atexit.register(shutil.rmtree, d, True)
        path = os.path.join(d, "avazu_synth_%d.libsvm" % SPARSE_FEATURES)
        t0 = time.monotonic()
        ex.synthesize(path, num_rows=SPARSE_DATA_ROWS,
                      num_features=SPARSE_FEATURES)
        _SPARSE_DATA.update(dir=d, path=path, s=time.monotonic() - t0)
    return _SPARSE_DATA["dir"], _SPARSE_DATA["path"], _SPARSE_DATA["s"]


def linear_example():
    """examples/sparse/linear_classification.py as a module whose
    imports of the JAX package name mxtpu_torch: its ``synthesize``,
    ``forward``, ``loss_fn``, ``evaluate`` and ``main`` run the port."""
    src, n = re.subn(r"^(import|from) mxtpu\b", r"\1 mxtpu_torch",
                     EXAMPLE.read_text(), flags=re.M)
    if n != 4:
        fail("sparse: %s has %d imports of the JAX package, not 4"
             % (EXAMPLE, n))
    mod = types.ModuleType("linear_classification_port")
    mod.__file__ = str(EXAMPLE)
    exec(compile(src, str(EXAMPLE), "exec"), mod.__dict__)
    return mod


def count_syncs(fn):
    """(fn()'s result, the host synchronisations it made), as
    torch.cuda's sync debug mode reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def zero_launches():
    for kern in KERNELS.values():
        kern.launches = 0


def read_launches():
    return {k: kern.launches for k, kern in KERNELS.items()}


class LinearRun(object):
    """examples/sparse/linear_classification.py's ``main()`` loop on the
    card: the weight (features, 2) from RandomState(1), a row-sparse
    gradient, the optimizer at ``rescale_grad`` 1 / batch, through an
    Updater or through ``kv.create(kvstore)`` (``set_optimizer``,
    ``row_sparse_pull`` of the batch's columns, rows-only pushes)."""

    def __init__(self, ex, it, optimizer, lr, kvstore, features, batch,
                 wd=0.0):
        self.ex, self.it = ex, it
        rng = np.random.RandomState(1)
        self.weight = mx.nd.array(rng.normal(0, 0.01, (features, 2))
                                  .astype(np.float32))
        self.bias = mx.nd.array(np.zeros((2,), np.float32))
        self.weight.attach_grad(stype="row_sparse")
        self.bias.attach_grad()
        self.opt = mx.optimizer.create(optimizer, learning_rate=lr, wd=wd,
                                       rescale_grad=1.0 / batch)
        self.updater = mx.optimizer.get_updater(self.opt)
        self.kv = mx.kv.create(kvstore) if kvstore else None
        if self.kv:
            self.kv.init("weight", self.weight)
            self.kv.init("bias", self.bias)
            self.kv.set_optimizer(self.opt)

    def pull(self, batch):
        if self.kv:
            self.kv.row_sparse_pull("weight", out=self.weight,
                                    row_ids=batch.data[0].indices)
            self.kv.pull("bias", out=self.bias)

    def forward(self, batch):
        with mx.autograd.record():
            logits = self.ex.forward(batch, self.weight, self.bias)
            return self.ex.loss_fn(logits, batch.label[0], 2.0)

    def update(self):
        if self.kv:
            self.kv.push("weight", self.weight.grad)
            self.kv.push("bias", self.bias.grad)
        else:
            self.updater(0, self.weight.grad, self.weight)
            self.updater(1, self.bias.grad, self.bias)

    def step(self, batch):
        self.pull(batch)
        loss = self.forward(batch)
        loss.backward()
        self.update()
        return loss

    def full_weight(self):
        """The trained weight (from the store, as the example fetches it
        for its evaluation)."""
        if self.kv:
            self.kv.row_sparse_pull("weight", out=self.weight,
                                    row_ids=mx.nd.array(np.arange(
                                        self.weight.shape[0],
                                        dtype=np.float32)))
            self.kv.pull("bias", out=self.bias)
        return self.weight


def linear_row(ex, it, name, optimizer, lr, kvstore):
    """One of the rows: SPARSE_EPOCHS epochs of the example's loop, then
    the host's split, a profiled batch and its syncs; fails unless the
    losses are finite and the second epoch's mean is below the first's."""
    free_card()
    run = LinearRun(ex, it, optimizer, lr, kvstore, SPARSE_FEATURES,
                    SPARSE_BATCH)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    epochs, walls = [], []
    for _ in range(SPARSE_EPOCHS):
        it.reset()
        t0 = time.monotonic()
        losses, nnz, stamps = [], 0, [t0]
        for batch in it:
            losses.append(run.step(batch)._data.detach())
            nnz += batch.data[0].nnz
            stamps.append(time.monotonic())
        epochs.append(torch.stack(losses).cpu().numpy())
        walls.append(time.monotonic() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    n_batches = len(epochs[-1])
    ms = walls[-1] / n_batches * 1e3
    spread = np.diff(stamps[:-1]) * 1e3  # the last batch waits for the sync
    it.reset()
    acc = ex.evaluate(it, run.full_weight(), run.bias)
    # the host's split: the batch made on the host (the card iterator's
    # triplets, cut into a CSR on the CPU), its copy to the card, then
    # the loop's stages, a sync after each
    host_it = copy.copy(it)
    host_it.ctx = mx.cpu()
    host_it.reset()
    gpu = mx.gpu(0)
    split = []
    for _ in range(SPARSE_SPLIT):
        stamps = [time.monotonic()]
        hb = host_it.next()
        stamps.append(time.monotonic())
        batch = mx.io.DataBatch([hb.data[0].copyto(gpu)],
                                [hb.label[0].copyto(gpu)], pad=hb.pad)
        torch.cuda.synchronize()
        stamps.append(time.monotonic())
        run.pull(batch)
        torch.cuda.synchronize()
        stamps.append(time.monotonic())
        loss = run.forward(batch)
        float(loss.asnumpy())
        stamps.append(time.monotonic())
        loss.backward()
        torch.cuda.synchronize()
        stamps.append(time.monotonic())
        run.update()
        torch.cuda.synchronize()
        stamps.append(time.monotonic())
        split.append(np.diff(stamps) * 1e3)
    split = dict(zip(("LibSVMIter.next (host)", "host-to-device copy",
                      "row_sparse_pull" if kvstore else "pull (none)",
                      "forward and loss", "backward",
                      "push" if kvstore else "update"),
                     np.median(split, axis=0).tolist()))
    it.reset()
    spans = device_spans(lambda: run.step(it.next()))
    if not spans:
        fail("%s: the profiler saw no device time in a batch" % name)
    busy, window, heads = profile_summary(spans, top=6)
    kinds = sorted(by_kind(spans, SPARSE_KINDS).items(),
                   key=lambda kv: -kv[1])

    def one_batch():
        batch = it.next()
        run.step(batch)
        return batch

    batch, syncs = count_syncs(one_batch)
    csr = batch.data[0]
    unique = int(run.weight.grad.indices.shape[0])
    nbytes = (csr.nnz * (4 + 8) + (csr.shape[0] + 1) * 8
              + csr.shape[0] * 4                       # CSR and labels
              + 2 * unique * 2 * 4                     # weight rows
              + (2 * unique * 2 * 4 if optimizer == "adagrad" else 0))
    bound = nbytes / PEAK_BYTES_S * 1e3
    means = [float(e.mean()) for e in epochs]
    log("[sparse] %s (%d features, batch %d, %d rows, %s lr %g, %s): "
        "mean loss by epoch %s: %.3f ms a batch (host clock, epoch %d of "
        "%d batches, synchronised by value; its batches before the last "
        "%.3f-%.3f ms), %.1f examples/s, %.4g nnz/s; the first epoch %.3f "
        "ms a batch; peak device memory %.1f MB allocated in the epochs "
        "(%.1f MB held before them); training accuracy after them %.4f "
        "(not a gate: most labels are noise at 1,000,000 features); "
        "flash-attention launches %s"
        % (name, SPARSE_FEATURES, SPARSE_BATCH, SPARSE_DATA_ROWS,
           optimizer, lr, "kvstore %s" % kvstore if kvstore else "Updater",
           " -> ".join("%.6f" % m for m in means), ms, SPARSE_EPOCHS,
           n_batches, spread.min(), spread.max(), SPARSE_BATCH / ms * 1e3,
           nnz / walls[-1], walls[0] / len(epochs[0]) * 1e3, peak / 1e6,
           held / 1e6, acc, launches))
    log("[sparse] %s: host ms a batch by stage (median of %d, a sync "
        "after each): %s; their sum %.3f"
        % (name, SPARSE_SPLIT, ", ".join("%s %.3f" % kv for kv in
                                         split.items()), sum(split.values())))
    log("[sparse] %s: one profiled batch: device busy %.3f ms, idle share "
        "at most %.3f, %d device operations, %d host syncs a batch (sync "
        "debug mode, which does not see the syncs inside coalesce's "
        "thrust calls); %d nnz, %d unique columns; bound %.4f ms (%.2f MB "
        "at 3.35 TB/s: the CSR batch, the touched weight rows%s read and "
        "written once)%s; by kind: %s; most device time: %s"
        % (name, busy, 1 - busy / window, len(spans), syncs, csr.nnz, unique,
           bound, nbytes / 1e6,
           " and their history" if optimizer == "adagrad" else "",
           "; the dense row_sparse_pull writes the whole (%d, 2) weight "
           "a batch too: %.1f MB, %.4f ms" % (
               SPARSE_FEATURES, SPARSE_FEATURES * 8 / 1e6,
               SPARSE_FEATURES * 8 / PEAK_BYTES_S * 1e3) if kvstore else "",
           "; ".join("%s %.3f ms" % (k, t / 1e3) for k, t in kinds),
           "; ".join("%s %.3f ms" % (n[:70], t / 1e3) for n, t in heads)))
    if not all(np.isfinite(e).all() for e in epochs):
        fail("%s: a loss is not finite" % name)
    if not means[-1] < means[0]:
        fail("%s: the loss does not fall by epoch: %s" % (name, means))
    if any(launches.values()):
        fail("%s: a flash-attention kernel launched: %s" % (name, launches))
    result = dict(ms=ms, examples_per_sec=SPARSE_BATCH / ms * 1e3,
                  nnz_per_sec=nnz / walls[-1], busy_ms=busy,
                  idle=1 - busy / window, ops=len(spans), syncs=syncs,
                  peak_mb=peak / 1e6, bound_ms=bound, host_ms=split,
                  loss_by_epoch=means, accuracy=acc, launches=launches)
    del run
    free_card()
    return result


def sparse_convergence(ex, workdir):
    """The example's own ``main()`` on the card at tests/test_examples.py's
    size (50,000 features, 1,500 rows, 2 epochs, AdaGrad), with no
    kvstore and with ``--kvstore local``: at least 0.9 training accuracy
    (its ``--min-accuracy`` exits non-zero below)."""
    accs = {}
    for kvstore in (None, "local"):
        argv = ["linear_classification.py", "--synthesize", "--num-epoch",
                "2", "--num-rows", "1500", "--num-features", "50000",
                "--min-accuracy", "0.9"]
        if kvstore:
            argv += ["--kvstore", kvstore]
        out = io.StringIO()
        saved = sys.argv, os.environ.get("MXTPU_DATA_DIR")
        sys.argv, os.environ["MXTPU_DATA_DIR"] = argv, workdir
        try:
            with contextlib.redirect_stdout(out):
                ex.main()
        except SystemExit as e:
            fail("sparse convergence (%s): the example exited %s: %s"
                 % (kvstore or "no kvstore", e.code, out.getvalue()[-300:]))
        finally:
            sys.argv = saved[0]
            if saved[1] is None:
                os.environ.pop("MXTPU_DATA_DIR", None)
            else:
                os.environ["MXTPU_DATA_DIR"] = saved[1]
        m = re.search(r"FINAL_ACCURACY ([0-9.]+)", out.getvalue())
        if not m or float(m.group(1)) < 0.9:
            fail("sparse convergence: %r" % out.getvalue()[-300:])
        accs[kvstore or "none"] = float(m.group(1))
    log("[sparse] convergence: the example's main() on the card at 50,000 "
        "features, 1,500 rows, 2 epochs, AdaGrad lr 0.1: final training "
        "accuracy %s (at least 0.9)"
        % ", ".join("%s %.4f" % kv for kv in accs.items()))


def _host_batch(batch):
    return mx.io.DataBatch([batch.data[0].copyto(mx.cpu())],
                           [batch.label[0].copyto(mx.cpu())])


def _plain_loss(logits, label, positive_cls_weight):
    """The example's loss_fn with its class weights on the logits'
    device (the example puts them on the default device, the card)."""
    logp = mx.nd.log_softmax(logits)
    lab = label.asnumpy()
    w = mx.nd.array(np.where(lab == 1, positive_cls_weight, 1.0)
                    .astype(np.float32), ctx=logits.ctx)
    per = -(logp * mx.nd.one_hot(label, depth=2)).sum(axis=1) * w
    return per.sum() / max(1, len(lab))


def sparse_cpu_check(ex, it):
    """One AdaGrad step of the linear classifier on a real batch, on the
    card and on the CPU from the same weights, with wd 0 and 1e-4: the
    touched rows and their history within SPARSE_CPU_TOL; every other
    row bitwise equal to its value before the step."""
    it.reset()
    batch = it.next()
    host = _host_batch(batch)
    w0 = np.random.RandomState(1).normal(0, 0.01, (SPARSE_FEATURES, 2)) \
        .astype(np.float32)
    report = []
    for wd in (0.0, 1e-4):
        got = []
        for dev, b in ((mx.gpu(0), batch), (mx.cpu(), host)):
            weight = mx.nd.array(w0, ctx=dev)
            bias = mx.nd.array(np.zeros((2,), np.float32), ctx=dev)
            weight.attach_grad(stype="row_sparse")
            bias.attach_grad()
            opt = mx.optimizer.create("adagrad", learning_rate=0.1, wd=wd,
                                      rescale_grad=1.0 / SPARSE_BATCH)
            upd = mx.optimizer.get_updater(opt)
            with mx.autograd.record():
                loss = _plain_loss(ex.forward(b, weight, bias), b.label[0],
                                   2.0)
            loss.backward()
            rows = weight.grad.indices._data.cpu()
            upd(0, weight.grad, weight)
            upd(1, bias.grad, bias)
            got.append((float(loss.asnumpy()), rows,
                        weight._data.detach().cpu(),
                        upd.states[0]._data.cpu()))
        (lc, rc, wc, hc), (lh, rh, wh, hh) = got
        if not torch.equal(rc, rh):
            fail("sparse: the card's gradient rows differ from the CPU's")
        untouched = torch.ones(SPARSE_FEATURES, dtype=torch.bool)
        untouched[rc] = False
        base = torch.from_numpy(w0)
        w_err = float((wc[rc] - wh[rc]).abs().max())
        h_err = float((hc[rc] - hh[rc]).abs().max() / hh[rc].abs().max())
        same = torch.equal(wc[untouched], base[untouched]) and \
            torch.equal(hc[untouched], torch.zeros_like(hc[untouched]))
        report.append((wd, abs(lc - lh), w_err, h_err, same,
                       int(untouched.sum())))
        if not same:
            fail("sparse: an untouched row changed in the lazy step (wd %g)"
                 % wd)
        if w_err > SPARSE_CPU_TOL["weight"] or \
                h_err > SPARSE_CPU_TOL["history"]:
            fail("sparse: the card's step is %.3g / %.3g from the CPU's "
                 "(weight / history; bounds %s)" % (w_err, h_err,
                                                    SPARSE_CPU_TOL))
    log("[sparse] one AdaGrad step, card against CPU on a batch of %d "
        "rows (%d touched rows): %s (bounds: weight %g absolute, history "
        "%g relative)"
        % (SPARSE_BATCH, len(rc), "; ".join(
            "wd %g: loss %.3g apart, touched weights %.3g, history %.3g, "
            "the %d untouched rows and their history bitwise as before: %s"
            % (wd, dl, we, he, n, s) for wd, dl, we, he, s, n in report),
           SPARSE_CPU_TOL["weight"], SPARSE_CPU_TOL["history"]))


def sparse_dot_check(path):
    """csr·W, csrᵀ·W and dense·csr on SPARSE_DOT_ROWS rows of the data,
    and the row-sparse gradient of csr·W, against the dense products of
    the densified CSR with TF32 off; the gradient's rows are the batch's
    unique column ids."""
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(SPARSE_FEATURES,),
                          batch_size=SPARSE_DOT_ROWS)
    csr = it.next().data[0]
    dense = csr.todense()._data
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(SPARSE_FEATURES, 2, device="cuda", generator=gen)
    wt = torch.randn(SPARSE_DOT_ROWS, 2, device="cuda", generator=gen)
    dl = torch.randn(3, SPARSE_DOT_ROWS, device="cuda", generator=gen)
    og = torch.randn(SPARSE_DOT_ROWS, 2, device="cuda", generator=gen)
    torch.backends.cuda.matmul.allow_tf32 = False
    sp = mx.nd.sparse
    errs = {
        "csr.W": rel_l2(sp.dot(csr, mx.nd.NDArray(w))._data, dense @ w),
        "csrT.W": rel_l2(sp.dot(csr, mx.nd.NDArray(wt),
                                transpose_a=True)._data, dense.t() @ wt),
        "D.csr": rel_l2(sp.dot(mx.nd.NDArray(dl), csr)._data, dl @ dense)}
    weight = mx.nd.NDArray(w.clone())
    weight.attach_grad(stype="row_sparse")
    with mx.autograd.record():
        out = sp.dot(csr, weight)
    out.backward(mx.nd.NDArray(og))
    grad = weight.grad
    errs["row-sparse gradient"] = rel_l2(grad.todense()._data, dense.t() @ og)
    rows_ok = torch.equal(grad.indices._data,
                          torch.unique(csr.indices._data))
    log("[sparse] sparse dot on %d rows x %d features (%d nnz) against the "
        "densified product (TF32 off), relative L2: %s; the gradient's %d "
        "rows are the batch's unique columns: %s (bound %g)"
        % (SPARSE_DOT_ROWS, SPARSE_FEATURES, csr.nnz,
           ", ".join("%s %.3g" % kv for kv in errs.items()),
           grad.indices.shape[0], rows_ok, SPARSE_DOT_TOL))
    if not rows_ok or max(errs.values()) > SPARSE_DOT_TOL:
        fail("sparse dot: %s, rows %s" % (errs, rows_ok))
    del dense
    free_card()


def sparse_kvstore_check():
    """Two row-sparse pushes of one key sum to their dense sum;
    row_sparse_pull into a row-sparse output holds exactly the requested
    rows, into a dense one zeros elsewhere (full width)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (SPARSE_FEATURES, 2)
    kv = mx.kv.create("local")
    kv.init("w", mx.nd.zeros(shape))
    parts = []
    for n in (5000, 7000):
        rows = torch.unique(torch.randint(0, SPARSE_FEATURES, (n,),
                                          device="cuda", generator=gen))
        vals = torch.randn(rows.numel(), 2, device="cuda", generator=gen)
        parts.append(mx.nd.sparse.row_sparse_array(
            (mx.nd.NDArray(vals), mx.nd.NDArray(rows)), shape=shape))
    kv.push("w", parts)
    out = mx.nd.zeros(shape)
    kv.pull("w", out=out)
    want = parts[0].todense()._data + parts[1].todense()._data
    sum_err = float((out._data - want).abs().max())
    store = torch.randn(shape, device="cuda", generator=gen)
    kv2 = mx.kv.create("local")
    kv2.init("w", mx.nd.NDArray(store))
    ids = torch.randint(0, SPARSE_FEATURES, (4096,), device="cuda",
                        generator=gen)
    rsp = mx.nd.sparse.zeros("row_sparse", shape)
    kv2.row_sparse_pull("w", out=rsp, row_ids=mx.nd.NDArray(ids))
    uniq = torch.unique(ids)
    rsp_ok = torch.equal(rsp.indices._data, uniq) and \
        torch.equal(rsp.data._data, store[uniq])
    dense = mx.nd.NDArray(torch.full(shape, 7.0, device="cuda"))
    kv2.row_sparse_pull("w", out=dense, row_ids=mx.nd.NDArray(ids))
    keep = torch.zeros(SPARSE_FEATURES, dtype=torch.bool, device="cuda")
    keep[uniq] = True
    dense_ok = torch.equal(dense._data[keep], store[keep]) and \
        not bool(dense._data[~keep].any())
    log("[sparse] kvstore on the card: two row-sparse pushes of %d and %d "
        "rows against their dense sum, max error %.3g; row_sparse_pull of "
        "%d ids (%d unique) into a row-sparse output: exactly those rows %s; "
        "into a dense one: those rows and zeros elsewhere %s"
        % (parts[0].indices.shape[0], parts[1].indices.shape[0], sum_err,
           ids.numel(), uniq.numel(), rsp_ok, dense_ok))
    if sum_err > 0 or not rsp_ok or not dense_ok:
        fail("sparse kvstore check failed")


def embedding_net(sparse, weight=None):
    with mx.sym.NameManager():
        net = mx.gluon.nn.Embedding(EMBED["vocab"], EMBED["dim"],
                                    sparse_grad=sparse)
    net.initialize(mx.init.Normal(0.01))
    if weight is not None:
        net.weight.set_data(weight)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": EMBED["lr"]})
    return net, trainer


def embedding_step(net, trainer, ids):
    with mx.autograd.record():
        loss = net(ids).sum()
    loss.backward()
    trainer.step(EMBED["ids"])
    return loss


def embedding_row(name, sparse, ids, weight):
    """gluon.nn.Embedding(1,000,000, 32) with sparse_grad or not and
    Trainer('sgd', lr 0.1), 512 random ids a step: ms a step, busy,
    operations, syncs, peak memory."""
    free_card()
    net, trainer = embedding_net(sparse, weight)
    for x in ids[:EMBED_WARM]:
        embedding_step(net, trainer, x)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.monotonic()
    for x in ids[EMBED_WARM:EMBED_WARM + EMBED_STEPS]:
        loss = embedding_step(net, trainer, x)
    float(loss.asnumpy())
    float(net.weight.data()._data.detach()[0, 0])
    ms = (time.monotonic() - t0) / EMBED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    spans = device_spans(lambda: embedding_step(net, trainer, ids[-1]))
    if not spans:
        fail("%s: the profiler saw no device time in a step" % name)
    busy, window, heads = profile_summary(spans, top=5)
    _, syncs = count_syncs(lambda: embedding_step(net, trainer, ids[-1]))
    log("[sparse] %s (vocabulary %d x %d, %d ids a step, SGD lr %g): %.3f "
        "ms a step (host clock, %d steps after %d warm), device busy %.3f "
        "ms, idle share at most %.3f, %d device operations and %d host "
        "syncs a step; peak device memory %.1f MB allocated in the timed "
        "steps (%.1f MB held before them: the table, the same weights "
        "kept for the other row, the ids); most device time: %s; "
        "flash-attention launches %s"
        % (name, EMBED["vocab"], EMBED["dim"], EMBED["ids"], EMBED["lr"], ms,
           EMBED_STEPS, EMBED_WARM, busy, 1 - busy / window, len(spans),
           syncs, peak / 1e6, held / 1e6,
           "; ".join("%s %.3f ms" % (n[:60], t / 1e3) for n, t in heads),
           launches))
    if any(launches.values()):
        fail("%s: a flash-attention kernel launched: %s" % (name, launches))
    result = dict(ms=ms, busy_ms=busy, idle=1 - busy / window,
                  ops=len(spans), syncs=syncs, peak_mb=peak / 1e6,
                  held_mb=held / 1e6, launches=launches)
    del net, trainer
    free_card()
    return result


def embedding_rows():
    """The sparse row and its dense twin, and one sparse step against one
    dense step from the same weights (within EMBED_TOL)."""
    gen = np.random.RandomState(0)
    ids = [mx.nd.array(gen.randint(0, EMBED["vocab"], EMBED["ids"])
                       .astype(np.float32))
           for _ in range(EMBED_WARM + EMBED_STEPS + 1)]
    mx.random.seed(0)
    weight = embedding_net(True)[0].weight.data().copy()
    nets = [embedding_net(s, weight) for s in (True, False)]
    for net, trainer in nets:
        embedding_step(net, trainer, ids[0])
    (sn, _), (dn, _) = nets
    err = float((sn.weight.data()._data - dn.weight.data()._data)
                .detach().abs().max())
    grad = sn.weight.grad()
    ids_ok = bool((grad.indices._data[1:] > grad.indices._data[:-1]).all()) \
        and torch.equal(grad.indices._data,
                        torch.unique(ids[0]._data.long()))
    log("[sparse] embedding: one sparse_grad step against one dense step "
        "from the same weights: max weight difference %.3g (bound %g); the "
        "row-sparse gradient's %d ids are the step's sorted unique ids: %s"
        % (err, EMBED_TOL, grad.indices.shape[0], ids_ok))
    if err > EMBED_TOL or not ids_ok:
        fail("embedding_sparse: the sparse step is %.3g from the dense one"
             " (ids %s)" % (err, ids_ok))
    del nets, sn, dn, grad
    free_card()
    rows = {"embedding_sparse": embedding_row("embedding_sparse", True, ids,
                                              weight),
            "embedding_dense": embedding_row("embedding_dense", False, ids,
                                             weight)}
    s, d = rows["embedding_sparse"], rows["embedding_dense"]
    log("[sparse] embedding: sparse_grad %.3f ms a step against dense "
        "%.3f (%s faster, %.2fx); peak %.1f MB against %.1f"
        % (s["ms"], d["ms"], "sparse" if s["ms"] < d["ms"] else "dense",
           max(s["ms"], d["ms"]) / min(s["ms"], d["ms"]), s["peak_mb"],
           d["peak_mb"]))
    return rows


def phase_sparse():
    """BASELINE config #5 on the card: the three linear classification
    rows, the example's convergence, the card-against-CPU step, the
    sparse dot and kvstore checks, the two embedding rows; returns each
    row's numbers (with its kernel launches)."""
    t0 = time.monotonic()
    ex = linear_example()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sparse_") as tmp:
        _, path, synth_s = sparse_data(ex)
        t2 = time.monotonic()
        it = mx.io.LibSVMIter(data_libsvm=path,
                              data_shape=(SPARSE_FEATURES,),
                              batch_size=SPARSE_BATCH)
        log("[sparse] data: the example's synthesize() at %d rows x %d "
            "features (seed 0, 20 power-law draws a row) in %.1f s; "
            "LibSVMIter parsed it in %.1f s"
            % (SPARSE_DATA_ROWS, SPARSE_FEATURES, synth_s,
               time.monotonic() - t2))
        rows = {}
        for name, optimizer, lr, kvstore in SPARSE_ROWS:
            rows[name] = linear_row(ex, it, name, optimizer, lr, kvstore)
        sparse_cpu_check(ex, it)
        sparse_dot_check(path)
        sparse_convergence(ex, tmp)
    sparse_kvstore_check()
    rows.update(embedding_rows())
    log("[sparse] the phase took %.1f s" % (time.monotonic() - t0))
    return rows


# ---------------------------------------------------------------------------
# dist: BASELINE config #5 over the parameter server; mnist: config #1
# ---------------------------------------------------------------------------

REPO_ROOT = Path(__file__).resolve().parent
# the launched workers run this script again, in a worker mode
WORKER_CMD = [sys.executable, str(Path(__file__).resolve())]
# ``python -m mxtpu_torch.tools.launch``'s module, run by its path: the
# launcher needs only the standard library, and ``-m`` would import the
# package, and with it torch, first (7.2 s for ``import torch`` alone on
# an NVIDIA H100 80GB HBM3, 700.00 W machine)
LAUNCHER = REPO_ROOT / "mxtpu_torch" / "tools" / "launch.py"
DIST_ROWS = (("linear_cls_dist_async", "dist_async"),
             ("linear_cls_dist_sync", "dist_sync"))
DIST_WORKERS = 2
# epochs over each worker's shard of the sparse phase's 65,536 rows: 4
# batches an epoch, 20 in all; the times are those of the last 4 epochs
# (6 epochs took the phase to 55.5 s on an NVIDIA H100 80GB HBM3,
# 700.00 W machine, near its 60)
DIST_EPOCHS = 5
# the example's --min-accuracy for the workers.  At DIST_EPOCHS a CPU
# rehearsal of the phase read 0.797 on every worker (at 6 epochs,
# 0.847-0.854 there and on the H100 machine, async and sync alike); a
# server that applies no push leaves the weight at its initial values,
# at about the labels' majority class (0.505), and 2 epochs read
# 0.543-0.545 (the example rescales by 1 / (batch x workers), which
# leaves AdaGrad's steps small).  That the server applied every push
# is checked by its versions too.
DIST_MIN_ACCURACY = 0.75
# the sync workers' final weight against the replay on the card: the
# server's dense AdaGrad on the CPU against the card's lazy one
DIST_REPLAY_TOL = 1e-5
DIST_LAUNCH_TIMEOUT = 150   # seconds, the launcher's --timeout
# a weight push: its value (two float32 a row) and its span (two int64)
DIST_ROW_BYTES = 2 * 4 + 2 * 8
DIST_FRAME_SLACK = 1024     # the frames' headers, a push's reply
MNIST_EXAMPLE = REPO_ROOT / "examples" / "image-classification" / \
    "train_mnist.py"
# 6,000 examples, batch 64; 2 epochs (the example's default is 3) keep
# the phase's launch under its time
MNIST_ARGS = ["--network", "lenet", "--dummy", "--num-epochs", "2"]
MNIST_BATCH = 64
MNIST_CPU_STEPS = 4
MNIST_CPU_TOL = 1e-4        # relative L2, the card's steps against the CPU's
# relative to the local run's movement (L2 from its initial to its
# final parameters): the dist_sync run's distance from the local run's
# final parameters (a server that applied nothing reads 1)
MNIST_DIST_TOL = 0.05


# written as ``sitecustomize.py`` into a directory put first on the
# launched processes' PYTHONPATH, so that the interpreter loads it at
# start-up in each of them; in the server role it times the server's
# ops (their nesting joined by "/"), the waits for its lock and its
# replies, and writes them when the role ends
SERVER_HOOK = '''\
import os
import sys

# load the interpreter's own sitecustomize, if it has one, as well
_here = os.path.dirname(os.path.abspath(__file__))
_me = sys.modules.pop("sitecustomize")
_path = list(sys.path)
sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or os.curdir) != _here]
try:
    import sitecustomize  # noqa: F401
except ImportError:
    pass
finally:
    sys.path[:] = _path
    sys.modules["sitecustomize"] = _me


def _install(path):
    import json
    import threading
    import time

    from mxtpu_torch import _ps

    stats, local = {}, threading.local()

    def note(name, t0):
        stats.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    def stack():
        return local.__dict__.setdefault("stack", [])

    class TimedLock(object):
        """The server's lock, timing each wait to take it (not the
        waits of its condition variable, which the ops' times hold)."""

        def __init__(self):
            self._lock = threading.Lock()

        def acquire(self, blocking=True, timeout=-1):
            t0 = time.perf_counter()
            ok = self._lock.acquire(blocking, timeout)
            if blocking:
                note("/".join(stack()) + " lock wait", t0)
            return ok

        __enter__ = acquire

        def __exit__(self, *exc):
            self._lock.release()

        def release(self):
            self._lock.release()

        def _is_owned(self):
            return self._lock.locked()

        def _release_save(self):
            self._lock.release()

        def _acquire_restore(self, state):
            self._lock.acquire()

    init = _ps.Server.__init__

    def server_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._lock = TimedLock()
        self._cv = threading.Condition(self._lock)

    _ps.Server.__init__ = server_init

    def timed(name, fn):
        def wrapper(self, *args, **kwargs):
            stack().append(name)
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                note("/".join(stack()), t0)
                stack().pop()
                local.last = name
        return wrapper

    for name in ("_push", "_push_rows", "_pull", "_pull_rows", "_apply",
                 "_wait_version_locked"):
        setattr(_ps.Server, name,
                timed(name.lstrip("_"), getattr(_ps.Server, name)))
    send = _ps._send_msg

    def send_msg(sock, obj):
        op, local.last = getattr(local, "last", None), None
        t0 = time.perf_counter()
        try:
            return send(sock, obj)
        finally:
            if op is not None:
                note(op + " reply", t0)

    _ps._send_msg = send_msg
    run = _ps.run_server

    def run_server(*args, **kwargs):
        try:
            return run(*args, **kwargs)
        finally:
            with open("%s.%d" % (path, os.getpid()), "w") as f:
                json.dump({k: list(v) for k, v in list(stats.items())}, f)

    _ps.run_server = run_server


if os.environ.get("MXTPU_ROLE") == "server" and \\
        os.environ.get("CHIP_SMOKE_SERVER_STATS"):
    _install(os.environ["CHIP_SMOKE_SERVER_STATS"])
'''


def launch_job(tag, worker_args, env_extra):
    """The port's launcher, ``-n 2 -s 1``, running this script with
    ``worker_args`` as each worker, its server timed by SERVER_HOOK:
    (its stdout, its seconds, the wall clock when it began, the
    server's times: {name: [ms]}).  Fails the run if the launch fails
    or outlives its time, or the server wrote no times."""
    cmd = [sys.executable, str(LAUNCHER), "-n", str(DIST_WORKERS), "-s",
           "1", "--timeout", str(DIST_LAUNCH_TIMEOUT)] + WORKER_CMD + \
        worker_args
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hook_") as hook:
        Path(hook, "sitecustomize.py").write_text(SERVER_HOOK)
        stats = os.path.join(hook, "server")
        env = dict(os.environ, CHIP_SMOKE_SERVER_STATS=stats, **env_extra)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (hook, str(REPO_ROOT), os.environ.get("PYTHONPATH"))
            if p)
        for name in ("MXTPU_ROLE", "DMLC_ROLE"):
            env.pop(name, None)
        t0, began = time.monotonic(), time.time()
        proc = subprocess.Popen(cmd, cwd=str(REPO_ROOT), env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=DIST_LAUNCH_TIMEOUT + 30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            out, err = proc.communicate()
            fail("%s: the launch outlived %d s: %s"
                 % (tag, DIST_LAUNCH_TIMEOUT + 30, (out + err)[-3000:]))
        if proc.returncode != 0:
            fail("%s: the launch exited %d: %s"
                 % (tag, proc.returncode, (out + err)[-3000:]))
        wall = time.monotonic() - t0
        files = [f for f in os.listdir(hook) if f.startswith("server.")]
        if len(files) != 1:
            fail("%s: %d servers wrote their times, not 1: %s"
                 % (tag, len(files), err[-2000:]))
        with open(os.path.join(hook, files[0])) as f:
            server = json.load(f)
    return out, wall, began, server


def server_summary(server):
    """{name: (count, mean ms, median ms, max ms)} of the server's times."""
    return {k: (len(v), float(np.mean(v)), float(np.median(v)),
                float(np.max(v))) for k, v in sorted(server.items())}


def log_server(phase, row, server):
    log("[%s] %s: the server's times (in its process; count, mean, "
        "median, max ms; nested ops joined by /): %s"
        % (phase, row, "; ".join(
            "%s %d, %.3f, %.3f, %.3f" % ((k,) + v)
            for k, v in server_summary(server).items())))


def server_versions(kv):
    """{key: [the server's version of each of its chunks]}: how many
    updates the server applied to each key of the store ``kv``."""
    w = kv._worker
    out = {}
    for key, (shape, _) in w._meta_shape.items():
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        out[str(key)] = [
            w._server_request(sidx, {"op": "version", "key": sub})["version"]
            for sidx, sub, _, _ in w._chunks(key, size)]
    return out


def _count_wire():
    """Wrap the parameter server's frame send and receive so that they
    count the bytes this process's main thread moves (the heartbeat
    thread's are left out); returns the counts."""
    from mxtpu_torch import _ps

    counts = {"sent": 0, "recv": 0}
    main_thread = threading.main_thread()

    class Counted(object):
        def __init__(self, sock):
            self.sock = sock

        def sendall(self, data):
            counts["sent"] += len(data)
            self.sock.sendall(data)

        def recv(self, n):
            data = self.sock.recv(n)
            counts["recv"] += len(data)
            return data

    send, recv = _ps._send_msg, _ps._recv_msg

    def counted_send(sock, obj):
        mine = threading.current_thread() is main_thread
        return send(Counted(sock) if mine else sock, obj)

    def counted_recv(sock):
        mine = threading.current_thread() is main_thread
        return recv(Counted(sock) if mine else sock)

    _ps._send_msg, _ps._recv_msg = counted_send, counted_recv
    return counts


def dist_worker(mode, out_dir):
    """One worker of the dist phase: the example's ``main()`` over the
    store ``mode``, its store timed and its frames counted; writes
    ``worker<rank>.json`` and the final pulled weight and bias."""
    counts = _count_wire()
    ex = linear_example()
    stores = []

    class TimedStore(mx.kv.KVStoreDist):
        """The example's store, timing each call of a batch (a sync
        before each push, so the step on the card is the step's)."""

        def __init__(self, name):
            super().__init__(name)
            self.batches, self.full_pulls, self.final = [], [], {}
            self.cur, self.eval_pull = None, False
            stores.append(self)

        def _mark(self):
            return time.monotonic(), counts["sent"], counts["recv"]

        def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
            t0 = self._mark()
            super().row_sparse_pull(key, out=out, row_ids=row_ids)
            torch.cuda.synchronize()
            t1 = time.monotonic()
            if row_ids.shape[0] == out.shape[0]:  # the evaluation's pull
                self.full_pulls.append((t1 - t0[0]) * 1e3)
                self.final["weight"] = out.asnumpy()
                self.eval_pull = True
                return
            self.cur = {"start": t0, "pull_ms": (t1 - t0[0]) * 1e3}

        def pull(self, key, out=None, priority=0, ignore_sparse=True):
            t0 = time.monotonic()
            super().pull(key, out=out)
            torch.cuda.synchronize()
            if self.eval_pull:
                self.final[key] = out.asnumpy()
                self.eval_pull = False
                return
            self.cur["pull_ms"] += (time.monotonic() - t0) * 1e3
            self.cur["pulled"] = time.monotonic()

        def push(self, key, value, priority=0):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            sent = counts["sent"]
            if key == "weight":
                self.cur["step_ms"] = (t0 - self.cur["pulled"]) * 1e3
                self.cur["push_ms"] = 0.0
                self.cur["unique_rows"] = int(value.indices.shape[0])
            super().push(key, value)
            self.cur["push_ms"] += (time.monotonic() - t0) * 1e3
            if key == "weight":
                self.cur["weight_push_bytes"] = counts["sent"] - sent
            else:
                start, s0, r0 = self.cur.pop("start")
                self.cur.update(start=start,
                                ms=(time.monotonic() - start) * 1e3,
                                sent=counts["sent"] - s0,
                                recv=counts["recv"] - r0)
                self.cur.pop("pulled")
                self.batches.append(self.cur)
                self.cur = None

        def close(self):
            # once every worker is here, all pushes are in (each is
            # acknowledged after the server applied or counted it)
            self.barrier()
            self.versions = server_versions(self)
            super().close()

    marks = {"import": T_IMPORT, "worker": time.time()}

    def store(name, ctx=None):
        kv = TimedStore(name)
        marks["store"] = time.time()
        return kv

    def data_iter(*args, **kwargs):
        it = mx.io.LibSVMIter(*args, **kwargs)
        marks["data"] = time.time()
        return it

    mx.kv.create = store
    ex.LibSVMIter = data_iter
    sys.argv = ["linear_classification.py", "--synthesize", "--num-epoch",
                str(DIST_EPOCHS), "--num-rows", str(SPARSE_DATA_ROWS),
                "--num-features", str(SPARSE_FEATURES), "--batch-size",
                str(SPARSE_BATCH), "--kvstore", mode, "--optimizer",
                "adagrad", "--lr", "0.1", "--min-accuracy",
                str(DIST_MIN_ACCURACY)]
    out = io.StringIO()
    code = 0
    zero_launches()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out):
            ex.main()
    except SystemExit as e:
        code = e.code
    wall = time.monotonic() - t0
    launches = read_launches()
    print(out.getvalue(), end="", flush=True)
    kv = stores[0]
    m = re.search(r"FINAL_ACCURACY ([0-9.]+)", out.getvalue())
    rank = kv.rank
    np.save(os.path.join(out_dir, "weight%d.npy" % rank),
            kv.final["weight"])
    np.save(os.path.join(out_dir, "bias%d.npy" % rank), kv.final["bias"])
    marks["end"] = time.time()
    with open(os.path.join(out_dir, "worker%d.json" % rank), "w") as f:
        json.dump({"rank": rank, "batches": kv.batches, "marks": marks,
                   "full_pull_ms": kv.full_pulls, "wall_s": wall,
                   "accuracy": float(m.group(1)) if m else None,
                   "versions": kv.versions, "launches": launches,
                   "exit": code}, f)
    if code:
        sys.exit(code)


def dist_replay(ex, path, rounds):
    """The sync job on the card in this process: from the example's
    initial weight, each round the two shards' batches' row-sparse
    gradients at the current weight, summed, then the lazy AdaGrad of
    the server's optimizer (``rescale_grad`` 1 / (batch x workers));
    returns (weight, bias)."""
    its = [mx.io.LibSVMIter(data_libsvm=path, data_shape=(SPARSE_FEATURES,),
                            batch_size=SPARSE_BATCH,
                            num_parts=DIST_WORKERS, part_index=k)
           for k in range(DIST_WORKERS)]
    rng = np.random.RandomState(1)
    weight = mx.nd.array(rng.normal(0, 0.01, (SPARSE_FEATURES, 2))
                         .astype(np.float32))
    bias = mx.nd.array(np.zeros((2,), np.float32))
    weight.attach_grad(stype="row_sparse")
    bias.attach_grad()
    opt = mx.optimizer.create("adagrad", learning_rate=0.1,
                              rescale_grad=1.0 / SPARSE_BATCH
                              / DIST_WORKERS)
    updater = mx.optimizer.get_updater(opt)
    done = 0
    for _ in range(DIST_EPOCHS):
        for it in its:
            it.reset()
        for batches in zip(*its):
            wgrads, bgrads = [], []
            for batch in batches:
                with mx.autograd.record():
                    loss = ex.loss_fn(ex.forward(batch, weight, bias),
                                      batch.label[0], 2.0)
                loss.backward()
                wgrads.append(weight.grad.copy())
                bgrads.append(bias.grad.copy())
            updater(0, mx.nd.sparse.add(wgrads[0], wgrads[1]), weight)
            updater(1, bgrads[0] + bgrads[1], bias)
            done += 1
    if done != rounds:
        fail("dist: the replay made %d rounds, the workers %d"
             % (done, rounds))
    return weight.asnumpy(), bias.asnumpy()


def dist_row(name, mode, tmp, data_dir, path):
    """One launch of the dist phase: each worker's times, bytes and
    accuracy; the server's times, taken in its process; the checks;
    the kernels' launches in the workers (and in this process's
    replay)."""
    out_dir = Path(tmp) / mode
    out_dir.mkdir()
    stdout, wall, began, server = launch_job(
        name, ["--dist-worker", mode, "--out", str(out_dir)],
        {"MXTPU_DATA_DIR": data_dir})
    workers = []
    for k in range(DIST_WORKERS):
        with open(out_dir / ("worker%d.json" % k)) as f:
            workers.append(json.load(f))
    if stdout.count("FINAL_ACCURACY") != DIST_WORKERS:
        fail("%s: %d FINAL_ACCURACY lines, not %d: %s"
             % (name, stdout.count("FINAL_ACCURACY"), DIST_WORKERS,
                stdout[-1000:]))
    per_epoch = SPARSE_DATA_ROWS // SPARSE_BATCH // DIST_WORKERS
    # every push applied: async, each worker's; sync, one a round
    want = per_epoch * DIST_EPOCHS * (DIST_WORKERS if mode == "dist_async"
                                      else 1)
    srv = server_summary(server)

    def srv_mean(k):
        return srv[k][1] if k in srv else 0.0

    def srv_total(k):
        return srv[k][0] * srv[k][1] if k in srv else 0.0

    # the server's handling of a weight push, means a push: the wait for
    # its lock to read the stored chunk, the dense expansion, the wait
    # for the lock to sum or apply, AdaGrad on CPU tensors (under sync,
    # one push in two applies); its two connections' threads share the
    # interpreter's lock, whose waits these times hold
    pushes = srv["push_rows"][0]
    weight_push = dict(
        ms=srv_mean("push_rows"),
        first_lock_wait=srv_mean("push_rows lock wait"),
        expansion=srv_mean("push_rows") - srv_mean("push_rows/push")
        - srv_mean("push_rows lock wait"),
        lock_wait=srv_mean("push_rows/push lock wait"),
        apply=srv_total("push_rows/push/apply") / pushes,
        apply_each=srv_mean("push_rows/push/apply"))
    rows = []
    for w in workers:
        b = w["batches"]
        if len(b) != DIST_EPOCHS * per_epoch:
            fail("%s: worker %d made %d batches" % (name, w["rank"], len(b)))
        window = b[per_epoch:]   # all but the first epoch
        # a batch from its pull to the next batch's of its epoch
        # (LibSVMIter.next in between; not the epoch's evaluation)
        gaps = [(window[i + 1]["start"] - window[i]["start"]) * 1e3
                for i in range(len(window) - 1) if (i + 1) % per_epoch]
        mean = {k: float(np.mean([x[k] for x in window]))
                for k in ("pull_ms", "step_ms", "push_ms", "sent", "recv")}
        mean["ms"] = float(np.mean(gaps))
        spread = (min(gaps), float(np.median(gaps)), max(gaps))
        if w["accuracy"] is None or w["accuracy"] < DIST_MIN_ACCURACY:
            fail("%s: worker %d's accuracy %s is below %s"
                 % (name, w["rank"], w["accuracy"], DIST_MIN_ACCURACY))
        for key, versions in sorted(w["versions"].items()):
            if versions != [want]:
                fail("%s: the server applied %s updates of %r, not %d"
                     % (name, versions, key, want))
        for x in b:
            need = x["unique_rows"] * DIST_ROW_BYTES
            if not need <= x["weight_push_bytes"] <= need + DIST_FRAME_SLACK:
                fail("%s: a weight push of %d unique rows sent %d bytes, "
                     "not %d-%d" % (name, x["unique_rows"],
                                    x["weight_push_bytes"], need,
                                    need + DIST_FRAME_SLACK))
        log("[dist] %s worker %d (%d features, batch %d, its shard of %d "
            "rows, %d epochs, AdaGrad lr 0.1, 2 workers and 1 server): "
            "%.3f ms a batch (host clock, from a batch's pull to the "
            "next's in its epoch: the mean of epochs 2-%d's %d; min %.1f, "
            "median %.1f, max %.1f; from its pull to its last push, all "
            "%s), %.1f examples/s; means over epochs 2-%d: "
            "row_sparse_pull and bias pull %.3f ms, the step on the card "
            "%.3f, the two pushes %.3f; %.0f bytes sent and %.0f received "
            "a batch; weight pushes of %s unique rows sent %s bytes (%d a "
            "row and the frame; a dense push would send %d); the "
            "evaluations' full pulls %s ms; FINAL_ACCURACY %.4f "
            "(--min-accuracy %s); the server's versions %s (%d expected); "
            "the worker's main() took %.1f s"
            % (name, w["rank"], SPARSE_FEATURES, SPARSE_BATCH,
               SPARSE_DATA_ROWS // DIST_WORKERS, DIST_EPOCHS, mean["ms"],
               DIST_EPOCHS, len(gaps), spread[0], spread[1], spread[2],
               " ".join("%.1f" % x["ms"] for x in b),
               SPARSE_BATCH / mean["ms"] * 1e3, DIST_EPOCHS,
               mean["pull_ms"], mean["step_ms"], mean["push_ms"],
               mean["sent"], mean["recv"],
               "/".join(str(x["unique_rows"]) for x in b),
               "/".join(str(x["weight_push_bytes"]) for x in b),
               DIST_ROW_BYTES, SPARSE_FEATURES * 8,
               " ".join("%.1f" % t for t in w["full_pull_ms"]),
               w["accuracy"], DIST_MIN_ACCURACY, w["versions"], want,
               w["wall_s"]))
        mk = w["marks"]
        first = b[0]
        log("[dist] %s worker %d: start-up from the launch (wall clock): "
            "its imports begin at %.1f s, its worker code at %.1f, the "
            "store joins the job at %.1f, LibSVMIter has its shard at %.1f, "
            "its main() ends at %.1f; the first batch %.1f ms (pulls "
            "%.1f, step %.1f, pushes %.1f)"
            % (name, w["rank"], mk["import"] - began,
               mk["worker"] - began, mk["store"] - began,
               mk["data"] - began, mk["end"] - began, first["ms"],
               first["pull_ms"], first["step_ms"], first["push_ms"]))
        rows.append(dict(rank=w["rank"], accuracy=w["accuracy"],
                         examples_per_sec=SPARSE_BATCH / mean["ms"] * 1e3,
                         ms_min_median_max=spread, **mean))
    log_server("dist", name, server)
    log("[dist] %s: the server's handling of a weight push (means of "
        "%d): %.3f ms, of which the wait for its lock to read the chunk "
        "%.3f, the dense expansion %.3f, the wait for its lock to sum or "
        "apply %.3f, AdaGrad on CPU tensors of %d x 2 %.3f (%.3f an "
        "update); of a row_sparse_pull %.3f ms (the wait for its round "
        "%.3f, the reply %.3f more), of a bias push %.3f, a bias pull %.3f"
        % (name, pushes, weight_push["ms"], weight_push["first_lock_wait"],
           weight_push["expansion"], weight_push["lock_wait"],
           SPARSE_FEATURES, weight_push["apply"], weight_push["apply_each"],
           srv_mean("pull_rows"), srv_mean("pull_rows/wait_version_locked"),
           srv_mean("pull_rows reply"), srv_mean("push"), srv_mean("pull")))
    weights = [np.load(out_dir / ("weight%d.npy" % k))
               for k in range(DIST_WORKERS)]
    biases = [np.load(out_dir / ("bias%d.npy" % k))
              for k in range(DIST_WORKERS)]
    result = dict(workers=rows, launch_s=wall, server_weight_push=weight_push,
                  server_pull_rows_ms=srv_mean("pull_rows"))
    zero_launches()
    if mode == "dist_sync":
        for k in range(1, DIST_WORKERS):
            if not (np.array_equal(weights[k], weights[0])
                    and np.array_equal(biases[k], biases[0])):
                fail("%s: the workers' final weights differ" % name)
        ex = linear_example()
        rw, rb = dist_replay(ex, path, len(workers[0]["batches"]))
        err = float(np.linalg.norm(weights[0] - rw) / np.linalg.norm(rw))
        berr = float(np.linalg.norm(biases[0] - rb)
                     / max(np.linalg.norm(rb), 1e-30))
        moved = float(np.linalg.norm(rw - np.random.RandomState(1).normal(
            0, 0.01, (SPARSE_FEATURES, 2)).astype(np.float32)))
        log("[dist] %s: the two workers' final weight and bias are bitwise "
            "equal; against the replay on the card (the lazy AdaGrad on "
            "the sum of the two shards' row-sparse gradients, %d rounds): "
            "relative L2 %.3g on the weight, %.3g on the bias (at most "
            "%g); the replay moved the weight by %.4f (L2)"
            % (name, len(workers[0]["batches"]), err, berr,
               DIST_REPLAY_TOL, moved))
        if not (err <= DIST_REPLAY_TOL and berr <= DIST_REPLAY_TOL):
            fail("%s: the sync weights are %.3g / %.3g from the replay"
                 % (name, err, berr))
        if not moved > 0:
            fail("%s: the replay did not move the weight" % name)
        result.update(replay_rel_l2=err)
    here = read_launches()
    launches = {k: here[k] + sum(w["launches"][k] for w in workers)
                for k in here}
    result["launches"] = launches
    if any(launches.values()):
        fail("%s: a flash-attention kernel launched: %s" % (name, launches))
    log("[dist] %s: the launch took %.1f s (4 processes: scheduler, "
        "server, 2 workers); flash-attention launches in the workers and "
        "the replay: %s" % (name, wall, launches))
    return result


def phase_dist():
    """BASELINE config #5 over the parameter server: the two rows, on
    the sparse phase's data (made here if this phase runs alone)."""
    t0 = time.monotonic()
    rows = {}
    data_dir, path, _ = sparse_data(linear_example())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        for name, mode in DIST_ROWS:
            rows[name] = dist_row(name, mode, tmp, data_dir, path)
    log("[dist] the phase took %.1f s" % (time.monotonic() - t0))
    return rows


def mnist_example():
    """examples/image-classification/train_mnist.py as a module of the
    port: its imports (the indented one too) name mxtpu_torch, and its
    ``mx.tpu()``/``mx.num_tpus()`` are ``mx.gpu()``/``mx.num_gpus()``."""
    src, n = re.subn(r"^(\s*)(import|from) mxtpu\b", r"\1\2 mxtpu_torch",
                     MNIST_EXAMPLE.read_text(), flags=re.M)
    src, m = re.subn(r"\bmx\.(tpu|num_tpus)\(",
                     lambda g: "mx.%s(" % {"tpu": "gpu",
                                           "num_tpus": "num_gpus"}[
                                               g.group(1)], src)
    if (n, m) != (4, 2):
        fail("mnist: %s has %d imports of the JAX package and %d TPU "
             "calls, not 4 and 2" % (MNIST_EXAMPLE, n, m))
    mod = types.ModuleType("train_mnist_port")
    mod.__file__ = str(MNIST_EXAMPLE)
    exec(compile(src, str(MNIST_EXAMPLE), "exec"), mod.__dict__)
    return mod


def run_mnist(kvstore):
    """The example's ``main()`` with ``--kv-store kvstore``, its Module
    stamping each batch's end, from ``mx.random.seed(0)`` (the
    initializer's draws); returns ms a batch over the last epoch, its
    batches, the validation accuracy, the parameters after
    ``init_params`` and at the end, the kernels' launches, and, for a
    distributed store, the worker's rank and the server's versions of
    each key (read once every worker is done; the store then closed)."""
    ex = mnist_example()
    mods = []

    class StampedModule(mx.mod.Module):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.stamps, self.scores, self.initial = [], [], None
            mods.append(self)

        def init_params(self, *args, **kwargs):
            super().init_params(*args, **kwargs)
            if self.initial is None:
                self.initial = {k: v.asnumpy()
                                for k, v in self.get_params()[0].items()}

        def fit(self, *args, batch_end_callback=None, **kwargs):
            cbs = list(batch_end_callback) \
                if isinstance(batch_end_callback, (list, tuple)) \
                else [batch_end_callback] if batch_end_callback else []

            def stamp(param):
                self.stamps.append((param.epoch, time.monotonic()))

            return super().fit(*args, batch_end_callback=cbs + [stamp],
                               **kwargs)

        def score(self, *args, **kwargs):
            res = super().score(*args, **kwargs)
            self.scores.append(res)
            return res

    saved = sys.argv, mx.mod.Module, logging.getLogger().level
    sys.argv = ["train_mnist.py"] + MNIST_ARGS + ["--kv-store", kvstore]
    mx.mod.Module = StampedModule
    mx.random.seed(0)
    zero_launches()
    try:
        code = ex.main()
    finally:
        sys.argv, mx.mod.Module = saved[0], saved[1]
        logging.getLogger().setLevel(saved[2])
    launches = read_launches()
    if code != 0:
        fail("mnist (%s): the example returned %s" % (kvstore, code))
    mod = mods[0]
    last = max(e for e, _ in mod.stamps)
    ts = [t for e, t in mod.stamps if e == last]
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    run = dict(ms=(ts[-1] - ts[0]) / (len(ts) - 1) * 1e3, batches=len(ts),
               updates=len(mod.stamps), accuracy=mod.scores[-1][0][1],
               params=params, initial=mod.initial, launches=launches,
               rank=0)
    if mod._kvstore is not None and "dist" in mod._kvstore.type:
        kv = mod._kvstore
        run["rank"] = kv.rank
        kv.barrier()
        run["versions"] = server_versions(kv)
        kv.close()
    return run


def mnist_worker(kvstore, out_dir):
    """One worker of the mnist phase's launch: writes its numbers and
    its initial and final parameters."""
    run = run_mnist(kvstore)
    params, initial = run.pop("params"), run.pop("initial")
    np.savez(os.path.join(out_dir, "params%d.npz" % run["rank"]), **params)
    np.savez(os.path.join(out_dir, "initial%d.npz" % run["rank"]),
             **initial)
    with open(os.path.join(out_dir, "worker%d.json" % run["rank"]),
              "w") as f:
        json.dump(run, f)


def mnist_cpu_check():
    """MNIST_CPU_STEPS steps of the example's LeNet through ``Module``
    (``forward_backward``, ``update``: SGD lr 0.1 momentum 0.9) on the
    card and on the CPU from the same parameters and batches (the
    example's synthetic data); the parameters' relative L2 distance,
    the worst array's, and the steps' movement."""
    ex = mnist_example()
    rng = np.random.RandomState(42)
    n = MNIST_CPU_STEPS * MNIST_BATCH
    x = rng.rand(n, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    out, start = {}, None
    for where, ctx in (("card", mx.gpu()), ("cpu", mx.cpu())):
        it = mx.io.NDArrayIter(x, y, MNIST_BATCH, label_name="softmax_label")
        mod = mx.mod.Module(ex.lenet_symbol(), context=[ctx])
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        if start is None:
            mx.random.seed(0)
            mod.init_params(mx.init.Uniform(0.01))
            start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        else:
            mod.set_params({k: mx.nd.array(v, ctx=ctx)
                            for k, v in start.items()}, {})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
        out[where] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    card, cpu = out["card"], out["cpu"]
    per = {k: float(np.linalg.norm(card[k] - cpu[k])
                    / np.linalg.norm(cpu[k])) for k in cpu}
    flat = [np.concatenate([d[k].ravel() for k in sorted(d)])
            for d in (card, cpu, start)]
    return (float(np.linalg.norm(flat[0] - flat[1])
                  / np.linalg.norm(flat[1])), per,
            float(np.linalg.norm(flat[1] - flat[2])
                  / np.linalg.norm(flat[2])))


def phase_mnist():
    """BASELINE config #1: LeNet through ``Module`` on the card against
    the CPU, then ``Module.fit`` local on the card in this process, then
    ``dist_sync`` over two launched workers and one server, held to the
    local run."""
    t0 = time.monotonic()
    rows = {}
    err, per, step_moved = mnist_cpu_check()
    worst = max(per, key=per.get)
    log("[mnist] %d steps of LeNet through Module (SGD lr 0.1 momentum "
        "0.9, batch %d) on the card against the CPU from the same "
        "parameters: relative L2 %.3g over all parameters, the worst "
        "array %s %.3g (bound %g); the steps moved them by %.3g (relative "
        "L2)" % (MNIST_CPU_STEPS, MNIST_BATCH, err, worst, per[worst],
                 MNIST_CPU_TOL, step_moved))
    if not max(err, per[worst]) <= MNIST_CPU_TOL:
        fail("mnist: the card's Module steps disagree with the CPU's")
    local = run_mnist("local")
    ms, n, acc = local["ms"], local["batches"], local["accuracy"]
    rows["mnist_lenet_local"] = dict(ms=ms, images_per_sec=MNIST_BATCH / ms
                                     * 1e3, accuracy=acc,
                                     launches=local["launches"])
    log("[mnist] mnist_lenet_local: train_mnist.py --network lenet --dummy "
        "(6,000 synthetic examples, batch 64, SGD lr 0.1 momentum 0.9, 2 "
        "epochs of Module.fit on the card, mx.random.seed(0)): %.3f ms a "
        "batch (host clock, the last epoch's %d batches), %.1f images/s; "
        "validation accuracy %.4f (random labels: about 0.1)"
        % (ms, n, MNIST_BATCH / ms * 1e3, acc))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mnist_") as tmp:
        _, wall, _, server = launch_job(
            "mnist_lenet_dist_sync",
            ["--mnist-worker", "dist_sync", "--out", tmp], {})
        workers, params, initial = [], [], []
        for k in range(DIST_WORKERS):
            with open(Path(tmp) / ("worker%d.json" % k)) as f:
                workers.append(json.load(f))
            params.append(dict(np.load(Path(tmp) / ("params%d.npz" % k))))
            initial.append(dict(np.load(Path(tmp) / ("initial%d.npz" % k))))
    for k in range(1, DIST_WORKERS):
        if sorted(params[k]) != sorted(params[0]) or not all(
                np.array_equal(params[k][p], params[0][p])
                for p in params[0]):
            fail("mnist_lenet_dist_sync: the workers' final parameters "
                 "differ")
    for w in workers:
        for key, versions in sorted(w["versions"].items()):
            if versions != [w["updates"]]:
                fail("mnist_lenet_dist_sync: the server applied %s updates "
                     "of %r, not %d" % (versions, key, w["updates"]))
        log("[mnist] mnist_lenet_dist_sync worker %d (2 workers, 1 server, "
            "the optimizer on the server): %.3f ms a batch (host clock, the "
            "last epoch's %d batches), %.1f images/s; validation accuracy "
            "%.4f; the server applied %d updates of each of %d keys"
            % (w["rank"], w["ms"], w["batches"],
               MNIST_BATCH / w["ms"] * 1e3, w["accuracy"], w["updates"],
               len(w["versions"])))
    log_server("mnist", "mnist_lenet_dist_sync", server)
    # both workers see the example's batches in the same order, so each
    # round's sum is twice the local step's gradient, and its rescale
    # half the local one: the dist run follows the local run from the
    # same initial parameters, apart from the two optimizers' rounding
    # (CPU and card) and the convolutions' order of summation
    if sorted(initial[0]) != sorted(local["initial"]) or not all(
            np.array_equal(initial[0][p], local["initial"][p])
            for p in initial[0]):
        fail("mnist_lenet_dist_sync: rank 0 did not start from the local "
             "row's parameters")
    flat = [np.concatenate([d[k].ravel() for k in sorted(d)])
            for d in (params[0], local["params"], local["initial"])]
    moved = float(np.linalg.norm(flat[1] - flat[2]))
    off = float(np.linalg.norm(flat[0] - flat[1])) / moved
    dist_moved = float(np.linalg.norm(flat[0] - flat[2])) / moved
    log("[mnist] mnist_lenet_dist_sync: the two workers' final parameters "
        "(%d arrays) are bitwise equal; from the same initial parameters "
        "as mnist_lenet_local, they lie %.3g of the local run's movement "
        "(L2 %.4f) from its final parameters (bound %g) and moved %.4f of "
        "it; the launch took %.1f s"
        % (len(params[0]), off, moved, MNIST_DIST_TOL, dist_moved, wall))
    if not off <= MNIST_DIST_TOL:
        fail("mnist_lenet_dist_sync: the final parameters are %.3g of the "
             "movement from the local run's" % off)
    rows["mnist_lenet_dist_sync"] = dict(
        workers=[dict(rank=w["rank"], ms=w["ms"], accuracy=w["accuracy"],
                      images_per_sec=MNIST_BATCH / w["ms"] * 1e3)
                 for w in workers], launch_s=wall, off_local=off,
        launches={k: sum(w["launches"][k] for w in workers)
                  for k in KERNELS})
    for name, r in rows.items():
        if any(r["launches"].values()):
            fail("%s: a flash-attention kernel launched: %s"
                 % (name, r["launches"]))
    log("[mnist] the phase took %.1f s" % (time.monotonic() - t0))
    return rows


# ---------------------------------------------------------------------------
# ops: the op corpus on the card against the CPU
# ---------------------------------------------------------------------------

# every canonical op the port registers, on the card against the same
# call on the CPU (tests/test_torch_op_cases.py's inputs): float32 within
# OPS_RTOL of the CPU's value plus OPS_ATOL of the output's largest
# magnitude, gamma, gammaln, erfinv, CTCLoss and flash attention within
# OPS_SPECIAL, the products (fp32_library, TF32 off) within
# OPS_PRODUCT_RTOL and OPS_PRODUCT_ATOL; integer and
# ordering results equal; the gradients of a random-weighted sum to the
# same bounds.  Random ops by shape, dtype, finiteness and moments (the
# mean and the variance within 4 standard errors), the multinomial,
# unique-zipfian and shuffle samplers by their contracts.
OPS_RTOL, OPS_ATOL = 1e-5, 1e-6
# (rtol, atol) apart: flash attention runs the CUDA kernels on the card,
# held to the kernel phase's float32 backward bound (BWD_TOL,
# tests/test_pallas_attention.py's); CTC sums its paths' probabilities
# over every frame in float32 log space, in another order on the card
OPS_SPECIAL = {"gamma": (1e-4, OPS_ATOL), "gammaln": (1e-4, OPS_ATOL),
               "erfinv": (1e-4, OPS_ATOL), "CTCLoss": (1e-4, OPS_ATOL),
               "_contrib_flash_attention": (2e-3, 2e-4)}
# a product's rounding scales with its terms, not its result: its atol
# is 1e-5 of the output's largest magnitude (on an H100 80GB HBM3 at
# 700 W the RNN op's input gradient read 1.4e-6 where 1e-6 of its
# largest would allow 1.1e-6)
OPS_PRODUCT_RTOL, OPS_PRODUCT_ATOL = 1e-4, 1e-5


def tests_module(name):
    """A helper module of tests/ that imports no JAX: the op cases, or
    the loader of train_imagenet.py."""
    sys.path.insert(0, str(REPO_ROOT / "tests"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def op_cases():
    """tests/test_torch_op_cases.py (the cases, ``run_call`` and
    ``error_units``), which imports only numpy."""
    return tests_module("test_torch_op_cases")


def op_random_checks(cases):
    """The samplers, BlockGrad's gradient and Dropout in training, on
    the card."""
    gpu = mx.gpu(0)
    for name, (_, mean, std, _) in cases.MOMENTS.items():
        mx.random.seed(3)
        x, dtype = cases.draw(mx, name, 200000, gpu)
        err_mean, err_var = cases.moment_errors(x, mean, std) \
            if np.isfinite(x).all() else (np.inf, np.inf)
        if not (x.shape == (200000,) and x.dtype == dtype
                and err_mean < 4 and err_var < 4):
            fail("ops: %s on the card: mean %.4f std %.4f, wanted %.4f %.4f "
                 "(%.2f and %.2f standard errors)" % (
                     name, x.mean(), x.std(), mean, std, err_mean, err_var))
    for name, bad in cases.random_contracts(mx, gpu):
        if bad is not None:
            fail("ops: %s on the card: %s" % (name, bad))
    a = mx.nd.array(cases._a(3, 4, seed=3), ctx=gpu)
    a.attach_grad()
    with mx.autograd.record():
        y = mx.nd.BlockGrad(a) * a
    y.backward()
    if not np.array_equal(a.grad.asnumpy(), a.asnumpy()):
        fail("ops: BlockGrad(a) * a has not the gradient a on the card")
    ones = mx.nd.ones((400, 500), ctx=gpu)
    with mx.autograd.train_mode():
        kept = mx.nd.Dropout(ones, p=0.25).asnumpy()
    frac = float((kept != 0).mean())
    if not (set(np.unique(kept)) <= {0.0, np.float32(1 / 0.75)}
            and abs(frac - 0.75) < 4 * np.sqrt(0.75 * 0.25 / kept.size)):
        fail("ops: Dropout(p=0.25) on the card kept %.4f" % frac)


def op_rel_l2(got, want):
    """The relative L2 of a floating result from the CPU's (NaNs where
    the CPU's are); 0 for an integer one (held equal elsewhere)."""
    g, w = np.asarray(got), np.asarray(want)
    if not np.issubdtype(w.dtype, np.floating) or g.shape != w.shape:
        return 0.0
    ok = ~np.isnan(w)
    g, w = g[ok].astype(np.float64), w[ok].astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-300))


def phase_ops():
    """Every registered op on the card against the CPU; returns the
    count of ops and the worst error."""
    t0 = time.monotonic()
    cases = op_cases()
    reg = mx.ops.registry
    canonical = sorted(n for n in reg.list_ops()
                       if reg.get_op(n).name == n)
    missing = sorted(set(canonical) ^ set(cases.CASES))
    if missing:
        fail("ops: registered ops and cases differ: %s" % missing)
    zero_launches()
    worst, rel, calls, grads, bad = {}, {}, 0, 0, []
    for name in canonical:
        op = reg.get_op(name)
        rtol, atol = (OPS_PRODUCT_RTOL, OPS_PRODUCT_ATOL) \
            if op.fp32_library else OPS_SPECIAL.get(name,
                                                    (OPS_RTOL, OPS_ATOL))
        for c in cases.CASES[name]:
            idx = cases.grad_inputs(op, c)
            got = cases.run_call(mx, name, c, mx.gpu(0), idx)
            want = cases.run_call(mx, name, c, mx.cpu(), idx)
            errs = [cases.error_units(g, w, c.exact, rtol, atol)
                    for g, w in zip(got[0] + got[1], want[0] + want[1])]
            if len(got[0]) != len(want[0]) or max(errs) > 1.0:
                bad.append((name, c.attrs, errs))
            worst[name] = max(worst.get(name, 0.0), max(errs))
            rel[name] = max([rel.get(name, 0.0)] + [
                op_rel_l2(g, w) for g, w in zip(got[0] + got[1],
                                                want[0] + want[1])
                if not c.exact])
            calls += 1
            grads += len(idx)
    for name, attrs, errs in bad:
        log("[ops] %s %s on the card against the CPU: outputs, then "
            "gradients, in units of the bound: %s" % (name, attrs, errs))
    if bad:
        fail("ops: %d calls disagree with the CPU" % len(bad))
    op_random_checks(cases)
    launches = read_launches()
    top = max(worst, key=worst.get)
    top_rel = max(rel, key=rel.get)
    log("[ops] %s: %d ops (%d calls, %d input gradients) on the card "
        "against the CPU, every one within its bound; the largest error "
        "as a fraction of its bound %.3g in %s; the largest relative L2 "
        "of a floating output or gradient %.3g in %s; samplers, "
        "BlockGrad and Dropout in training by moments; flash-attention "
        "launches in the comparisons %s; the phase took %.1f s"
        % (card(), len(canonical), calls, grads, worst[top], top,
           rel[top_rel], top_rel, launches, time.monotonic() - t0))
    # the flash op's calls here compare the kernels with the CPU's plain
    # path: they are not the main path's, and the kernels' record
    # leaves them out
    zero_launches()
    return dict(ops=len(canonical), calls=calls, worst=worst[top],
                worst_op=top, worst_rel=rel[top_rel], worst_rel_op=top_rel,
                compare_launches=launches)


# ---------------------------------------------------------------------------
# zoo: BASELINE config #2's script training MobileNet v2, and the other
# model-zoo families on the card
# ---------------------------------------------------------------------------

ZOO_EXAMPLE = REPO_ROOT / "examples" / "gluon" / "image_classification.py"
ZOO_ARGS = ["--model", "mobilenet_v2_1_0", "--classes", "1000",
            "--batch-size", "32", "--image-shape", "3,224,224"]
ZOO_BATCH, ZOO_CLASSES, ZOO_SIDE = 32, 1000, 224
ZOO_WARM, ZOO_STEPS, ZOO_LR = 2, 20, 0.05
# one batch-2 Trainer step on the card against the CPU from the same
# weights (zoo_step_check, relative L2): float32's loss and moving stats
# within ZOO_CPU_TOL, float64's updates within ZOO_F64_TOL; float32's
# updates as resnet_step_check holds them (all together within 2x, each
# parameter within 3x the CPU's own distance from float64, with its
# floors), the CPU's distance the largest of ZOO_CPU_RUNS and, per
# parameter, at least the CPU's relative distance for all updates; and a
# batch-1 forward of each family within ZOO_CPU_TOL
ZOO_CPU_TOL, ZOO_F64_TOL = 1e-4, 1e-6
ZOO_CPU_RUNS = ("oneDNN convolutions", "native convolutions", "one thread")
ZOO_FAMILIES = (("mobilenet1_0", 224), ("densenet121", 224),
                ("inception_v3", 299), ("squeezenet1_1", 224),
                ("vgg16_bn", 224), ("alexnet", 224))
ZOO_FWD_BATCH, ZOO_FWD_TIMED = 8, 5
ZOO_KINDS = (("depthwise convolution", ("depthwise", "dwconv")),) + KINDS


def zoo_example():
    """examples/gluon/image_classification.py as a module of the port:
    its imports name mxtpu_torch, its ``mx.tpu()``/``mx.num_tpus()``
    are ``mx.gpu()``/``mx.num_gpus()``."""
    src, n = re.subn(r"^(import|from) mxtpu\b", r"\1 mxtpu_torch",
                     ZOO_EXAMPLE.read_text(), flags=re.M)
    src, m = re.subn(r"\bmx\.(tpu|num_tpus)\(",
                     lambda g: "mx.%s(" % {"tpu": "gpu",
                                           "num_tpus": "num_gpus"}[
                                               g.group(1)], src)
    if (n, m) != (3, 2):
        fail("zoo: %s has %d imports of the JAX package and %d TPU calls, "
             "not 3 and 2" % (ZOO_EXAMPLE, n, m))
    mod = types.ModuleType("image_classification_port")
    mod.__file__ = str(ZOO_EXAMPLE)
    exec(compile(src, str(ZOO_EXAMPLE), "exec"), mod.__dict__)
    return mod


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def zoo_example_run():
    """The script's ``main()`` with ZOO_ARGS (its own settings:
    hybridized, SoftmaxCrossEntropyLoss, Trainer SGD lr 0.05 momentum
    0.9, 10 batches of fresh random images); returns its epoch line and
    the seconds it took."""
    ex = zoo_example()
    lines, root = _Lines(), logging.getLogger()
    saved = sys.argv, root.level
    root.addHandler(lines)
    root.setLevel(logging.INFO)
    sys.argv = [str(ZOO_EXAMPLE)] + ZOO_ARGS
    t0 = time.monotonic()
    try:
        rc = ex.main()
        torch.cuda.synchronize()
    finally:
        sys.argv = saved[0]
        root.removeHandler(lines)
        root.setLevel(saved[1])
    epoch = [l for l in lines.lines if l.startswith("epoch")]
    if rc != 0 or not epoch:
        fail("zoo: the example returned %r and logged %s" % (rc, lines.lines))
    return epoch[-1], time.monotonic() - t0


def zoo_net(name, ctx, init=None, hybridize=True):
    """A zoo model of 1000 classes in a fresh NameManager (so two builds
    have the same names), initialized after ``random.seed(0)``."""
    with mx.sym.NameManager():
        net = getattr(mx.gluon.model_zoo.vision, name)(classes=ZOO_CLASSES)
    mx.random.seed(0)
    net.initialize(init, ctx=ctx)
    if hybridize:
        net.hybridize()
    return net


def zoo_batch(batch, side, ctx, seed=0):
    rng = np.random.RandomState(seed)
    return (mx.nd.array(rng.rand(batch, 3, side, side).astype(np.float32),
                        ctx=ctx),
            mx.nd.array(rng.randint(0, ZOO_CLASSES, batch).astype(
                np.float32), ctx=ctx))


def zoo_trainer(net):
    return mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": ZOO_LR, "momentum": 0.9})


def zoo_row():
    """MobileNet v2 1.0 as the script trains it, on a fixed batch of 32
    at 224²: 2 warm and 20 timed steps synchronised by value, the
    host's split and one profiled step."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    gpu = mx.gpu(0)
    x, y = zoo_batch(ZOO_BATCH, ZOO_SIDE, gpu)
    net = zoo_net("mobilenet_v2_1_0", gpu)
    trainer = zoo_trainer(net)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []

    def step():
        losses.append(gluon_step(net, trainer, loss_fn, x, y)._data.detach())

    zero_launches()
    t0 = time.monotonic()
    step()  # traces the net, draws the weights
    float(losses[-1][0])
    setup_s = time.monotonic() - t0
    for _ in range(ZOO_WARM - 1):
        step()
    float(losses[-1][0])
    t1 = time.monotonic()
    for _ in range(ZOO_STEPS):
        step()
    float(losses[-1][0])
    wall = time.monotonic() - t1
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    host = gluon_host_split(net, trainer, loss_fn, x, y)
    spans = device_spans(step)
    if not spans:
        fail("zoo: the profiler saw no device time in a step")
    busy, window, heads = profile_summary(spans)
    idle, ops = 1 - busy / window, len(spans)
    kinds = sorted(by_kind(spans, ZOO_KINDS).items(), key=lambda kv: -kv[1])
    timed = torch.stack([l.float().mean() for l in
                         losses[ZOO_WARM:ZOO_WARM + ZOO_STEPS]]).cpu()
    ms = wall / ZOO_STEPS * 1e3
    ips = ZOO_STEPS * ZOO_BATCH / wall
    log("[zoo] %s: mobilenet_v2_gluon (mobilenet_v2_1_0, 1000 classes, "
        "batch %d, %d², fp32 with TF32 off, hybridized, SGD lr %g "
        "momentum 0.9, one fixed batch): %d timed steps after %d warm: "
        "%.3f s (host clock, synchronised by value): %.3f ms a step, %.2f "
        "images/s; set-up and first step %.1f s"
        % (card(), ZOO_BATCH, ZOO_SIDE, ZOO_LR, ZOO_STEPS, ZOO_WARM, wall,
           ms, ips, setup_s))
    log("[zoo] %s: mobilenet_v2_gluon, one profiled step: device busy "
        "%.3f ms, idle share at most %.3f, %d device operations; peak "
        "device memory %.1f MB allocated; by kind: %s; most device time: %s"
        % (card(), busy, idle, ops, peak / 1e6,
           "; ".join("%s %.3f ms" % (k, t / 1e3) for k, t in kinds),
           "; ".join("%s %.3f ms" % (n[:70], t / 1e3) for n, t in heads)))
    log("[zoo] %s: mobilenet_v2_gluon, host ms a step by stage (median of "
        "5 steps, no sync inside a step): %s; their sum %.3f ms"
        % (card(), ", ".join("%s %.3f" % kv for kv in host.items()),
           sum(host.values())))
    log("[zoo] mobilenet_v2_gluon: the timed steps' mean losses: %s"
        % " ".join("%.4f" % v for v in timed.tolist()))
    if not bool(torch.isfinite(timed).all()) or not timed[-1] < timed[0]:
        fail("zoo: mobilenet_v2_gluon's losses not finite or not falling: "
             "%s" % timed.tolist())
    if any(launches.values()):
        fail("zoo: a flash-attention kernel launched: %s" % launches)
    result = dict(ms=ms, imgs_per_sec=ips, busy_ms=busy, idle=idle, ops=ops,
                  peak_mb=peak / 1e6, launches=launches, host_ms=host,
                  kinds_ms={k: t / 1e3 for k, t in kinds})
    del net, trainer, losses
    free_card()
    return result


class cpu_float32:
    """One of ZOO_CPU_RUNS: a float32 implementation of the same step on
    the CPU, torch's default (oneDNN's convolutions), its native
    convolutions, or one thread (another split of each reduction)."""

    def __init__(self, how):
        self.how = how

    def __enter__(self):
        self.threads = torch.get_num_threads()
        self.flags = torch.backends.mkldnn.flags(
            enabled=self.how != "native convolutions")
        self.flags.__enter__()
        if self.how == "one thread":
            torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.threads)
        self.flags.__exit__(*exc)


def zoo_step_check():
    """One batch-2 Trainer step of mobilenet_v2_1_0 (SGD lr 0.05,
    momentum 0.9) on the card against the same step on the CPU from the
    same weights.  As in ``resnet_step_check``, the step is
    ill-conditioned at batch 2: the global pool hands the last BatchNorm
    a gradient constant over its 49 positions, which its backward mostly
    cancels, so float32 rounding moves the weights' updates below it by
    up to a few percent.  So the same function is held in float64, where
    rounding is far below what the step amplifies: the card's float64
    updates within ZOO_F64_TOL of the CPU's, all together and each
    parameter (plus 1e-3 of the largest update, for the betas whose
    exact update is zero).  In float32 the loss and the moving stats
    (well conditioned) agree with the CPU's within ZOO_CPU_TOL, and the
    updates are held as ``resnet_step_check`` holds ResNet's: all
    together within 2x the CPU's own distance from float64 plus 1e-3 of
    the exact update, each parameter within 3x its CPU distance plus
    1e-3 of its exact update and 1e-6 of the largest.  One float32 run
    is one draw of the rounding that the step amplifies, and per
    parameter two draws differ by factors of several, so the CPU's
    distance is the largest over ZOO_CPU_RUNS, three float32
    implementations of the step, and a parameter's is at least the
    CPU's relative distance for all updates together times its exact
    update (one draw may fall far below the step's float32 noise).  On
    an H100 80GB HBM3 at 700 W the card's float32 step is 1.9x as far
    from float64 as the CPU's, alike with cuDNN's default, deterministic
    or benchmarked algorithms and with cuDNN off; per parameter its
    distance over the largest CPU run's has median 1.53, 90th
    percentile 1.66 and maximum 3.29 (a depthwise weight of block 14).
    The same step with TF32 on must break those bounds."""
    free_card()
    t0 = time.monotonic()
    on_card = zoo_net("mobilenet_v2_1_0", mx.gpu(0))
    x, _ = zoo_batch(2, ZOO_SIDE, mx.gpu(0), seed=1)
    with mx.autograd.pause():
        on_card(x)  # draws the weights
    start = {n: p.data().asnumpy() for n, p in
             on_card.collect_params().items()}
    learned = sorted(n for n, p in on_card.collect_params().items()
                     if p.grad_req != "null")
    del on_card

    def step(ctx, dtype="float32"):
        net = zoo_net("mobilenet_v2_1_0", ctx)
        mx.gluon.parameter.load_numpy(net.collect_params(), start)
        x, y = zoo_batch(2, ZOO_SIDE, ctx, seed=1)
        if dtype != "float32":
            net.cast(dtype)
            x, y = x.astype(dtype), y.astype(dtype)
        loss = gluon_step(net, zoo_trainer(net),
                          mx.gluon.loss.SoftmaxCrossEntropyLoss(), x, y)
        new = {n: p.data().asnumpy().astype(np.float64) for n, p in
               net.collect_params().items()}
        return (loss.asnumpy().astype(np.float64),
                {n: new[n] - start[n] for n in learned},
                {n: new[n] for n in start if n not in learned})

    def rel(a, b, keys):
        return float(np.sqrt(sum(np.linalg.norm(a[k] - b[k]) ** 2
                                 for k in keys)
                             / sum(np.linalg.norm(b[k]) ** 2 for k in keys)))

    def dist(upd, exact):
        per = {k: np.linalg.norm(upd[k] - exact[k]) for k in learned}
        return per, float(np.linalg.norm([per[k] for k in learned]))

    card_loss, card_upd, card_stats = step(mx.gpu(0))
    with tf32_on():
        _, tf32_upd, _ = step(mx.gpu(0))
    cpu = {}
    for how in ZOO_CPU_RUNS:
        with cpu_float32(how):
            cpu[how] = step(mx.cpu())
    cpu_loss, _, cpu_stats = cpu[ZOO_CPU_RUNS[0]]
    _, ex_upd, _ = step(mx.cpu(), "float64")
    _, card64_upd, _ = step(mx.gpu(0), "float64")
    free_card()
    norm = {k: np.linalg.norm(ex_upd[k]) for k in learned}
    all_norm = float(np.linalg.norm([norm[k] for k in learned]))
    largest = max(norm.values())
    # float64: each parameter in units of ZOO_F64_TOL of its update plus
    # 1e-3 of the largest (the floor for the betas whose exact update is
    # zero: a BatchNorm follows their output)
    per64 = {k: np.linalg.norm(card64_upd[k] - ex_upd[k]) / (
        ZOO_F64_TOL * (norm[k] + 1e-3 * largest)) for k in learned}
    worst64 = max(per64, key=per64.get)
    all64 = rel(card64_upd, ex_upd, learned)
    # float32: the CPU's distance from float64, the largest over its runs
    cpu_dist = {how: dist(run[1], ex_upd) for how, run in cpu.items()}
    cpu_all = max(d[1] for d in cpu_dist.values())
    cpu_per = {k: max([d[0][k] for d in cpu_dist.values()]
                      + [cpu_all / all_norm * norm[k]]) for k in learned}
    allowed = {k: 3 * cpu_per[k] + 1e-3 * norm[k] + 1e-6 * largest
               for k in learned}
    all_allowed = 2 * cpu_all + 1e-3 * all_norm

    def verdict(upd):
        per, total = dist(upd, ex_upd)
        ratio = {k: per[k] / allowed[k] for k in learned}
        worst = max(ratio, key=ratio.get)
        return ratio, worst, total / all_allowed

    ratio, worst, total = verdict(card_upd)
    tf32_ratio, tf32_worst, tf32_total = verdict(tf32_upd)
    loss_err = float(np.linalg.norm(card_loss - cpu_loss)
                     / np.linalg.norm(cpu_loss))
    stats_err = rel(card_stats, cpu_stats, list(cpu_stats))
    # the card's distance per parameter over the largest CPU run's (no
    # floor): median, 90th percentile, maximum and its parameter
    card_per, card_all = dist(card_upd, ex_upd)
    over = {k: card_per[k] / max(max(d[0][k] for d in cpu_dist.values()),
                                 1e-300) for k in learned}
    spread = np.percentile(list(over.values()), [50, 90])
    most = max(over, key=over.get)
    top = sorted(ratio, key=ratio.get, reverse=True)[:5]
    log("[zoo] %s: one batch-2 Trainer step of mobilenet_v2_1_0 from the "
        "same weights: float64, the card's %d updates vs the CPU's %.3g "
        "(relative L2, bound %g), the worst parameter %s at %.3g of its "
        "bound; float32, card vs CPU: the loss %.3g, the moving stats %.3g "
        "(bound %g); %.1f s"
        % (card(), len(learned), all64, ZOO_F64_TOL, worst64,
           per64[worst64], loss_err, stats_err, ZOO_CPU_TOL,
           time.monotonic() - t0))
    log("[zoo] %s: the float32 updates against float64 (relative L2): the "
        "CPU's %s; the card's %.4g, %.3g of its bound (2x the largest CPU "
        "distance); per parameter, the card's distance over the largest "
        "CPU run's: median %.3g, 90th percentile %.3g, maximum %.3g (%s); "
        "against the bound (3x the largest CPU distance, at least the "
        "relative one of all updates) the worst %s; with TF32 on the "
        "card's %.4g, %.3g of the bound for all, the worst parameter %s at "
        "%.3g of its bound"
        % (card(), ", ".join("%s %.4g" % (how, d[1] / all_norm)
                             for how, d in cpu_dist.items()),
           card_all / all_norm, total, spread[0], spread[1], over[most],
           most, ", ".join("%s %.3g" % (k, ratio[k]) for k in top),
           dist(tf32_upd, ex_upd)[1] / all_norm, tf32_total, tf32_worst,
           tf32_ratio[tf32_worst]))
    if not (all64 <= ZOO_F64_TOL and per64[worst64] <= 1
            and loss_err <= ZOO_CPU_TOL and stats_err <= ZOO_CPU_TOL
            and ratio[worst] <= 1 and total <= 1):
        fail("zoo: the card's step disagrees with the CPU's")
    if tf32_total <= 1 and tf32_ratio[tf32_worst] <= 1:
        fail("zoo: the step check does not tell TF32's step from float32's")


def zoo_families():
    """A batch-8 forward of each other family at full width, finite and
    (8, 1000), its ms; and a batch-1 forward against the CPU's from the
    same weights within ZOO_CPU_TOL."""
    rows = {}
    for name, side in ZOO_FAMILIES:
        free_card()
        zero_launches()
        net = zoo_net(name, mx.gpu(0), mx.init.Xavier())
        x, _ = zoo_batch(ZOO_FWD_BATCH, side, mx.gpu(0), seed=2)
        with mx.autograd.pause():
            out = net(x)  # traces the net, draws the weights
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(ZOO_FWD_TIMED):
                out = net(x)
            out = out.asnumpy()
            ms = (time.monotonic() - t0) / ZOO_FWD_TIMED * 1e3
            if out.shape != (ZOO_FWD_BATCH, ZOO_CLASSES) or \
                    not np.isfinite(out).all():
                fail("zoo: %s gave %s, finite %s" % (
                    name, out.shape, np.isfinite(out).all()))
            weights = {n: p.data().asnumpy() for n, p in
                       net.collect_params().items()}
            cpu = zoo_net(name, mx.cpu())
            mx.gluon.parameter.load_numpy(cpu.collect_params(), weights)
            one = x.asnumpy()[:1]
            got = net(mx.nd.array(one, ctx=mx.gpu(0))).asnumpy()
            want = cpu(mx.nd.array(one, ctx=mx.cpu())).asnumpy()
        err = rel_l2(torch.from_numpy(got), torch.from_numpy(want))
        rows["zoo_" + name] = dict(ms=ms, side=side, cpu_err=err,
                                   launches=read_launches())
        log("[zoo] %s: %s (%d², 1000 classes, Xavier, hybridized, "
            "predict mode): a batch-%d forward %.3f ms (host clock, "
            "synchronised by value, the mean of %d); batch 1 on the card "
            "vs the CPU from the same weights: relative L2 %.3g (bound %g)"
            % (card(), name, side, ZOO_FWD_BATCH, ms, ZOO_FWD_TIMED, err,
               ZOO_CPU_TOL))
        if not err <= ZOO_CPU_TOL:
            fail("zoo: %s on the card is %.3g from the CPU" % (name, err))
        del net, cpu
    free_card()
    return rows


def phase_zoo():
    """BASELINE config #2: the example script training MobileNet v2 on
    the card, its own row and its step against the CPU, then the other
    families; returns the rows (with their kernel launches)."""
    t0 = time.monotonic()
    zero_launches()
    line, secs = zoo_example_run()
    rows = {"zoo_example": dict(seconds=secs, launches=read_launches())}
    log("[zoo] %s: examples/gluon/image_classification.py %s (10 batches of "
        "fresh random images): %s; %.1f s with its trace" % (
            card(), " ".join(ZOO_ARGS), line, secs))
    rows["mobilenet_v2_gluon"] = zoo_row()
    zoo_step_check()
    rows.update(zoo_families())
    for name, r in rows.items():
        if any(r["launches"].values()):
            fail("zoo: %s launched a flash-attention kernel: %s"
                 % (name, r["launches"]))
    log("[zoo] the phase took %.1f s" % (time.monotonic() - t0))
    return rows


# ---------------------------------------------------------------------------
# imagenet: BASELINE config #4's script training ResNet-50 v1 under NAG
# ---------------------------------------------------------------------------

IMAGENET_BATCH, IMAGENET_EPOCHS, IMAGENET_BATCHES = 128, 2, 20
IMAGENET_SIDE, IMAGENET_CLASSES = 224, 1000
IMAGENET_ARGS = ["--benchmark", "1", "--network", "resnet", "--num-layers",
                 "50", "--num-classes", str(IMAGENET_CLASSES),
                 "--image-shape", "3,%d,%d" % (IMAGENET_SIDE, IMAGENET_SIDE),
                 "--batch-size", str(IMAGENET_BATCH),
                 "--kv-store", "device", "--optimizer", "nag", "--mom",
                 "0.9", "--wd", "1e-4", "--lr", "0.1", "--initializer",
                 "msra", "--top-k", "5", "--num-epochs",
                 str(IMAGENET_EPOCHS), "--max-batches",
                 str(IMAGENET_BATCHES), "--disp-batches", "10"]


class host_split:
    """The host's seconds in Module.forward, backward and update, and
    the optimizer's per-parameter updates, for each step of the run."""

    def __init__(self):
        self.steps, self.updates = [], 0
        self._cur = {}

    def __enter__(self):
        cls = mx.mod.Module
        self.saved = {n: getattr(cls, n)
                      for n in ("forward", "backward", "update")}
        self.saved_call = mx.optimizer.Updater.__call__

        def timed(name, fn):
            def wrapper(mod, *args, **kwargs):
                t0 = time.perf_counter()
                out = fn(mod, *args, **kwargs)
                self._cur[name] = self._cur.get(name, 0.0) + \
                    time.perf_counter() - t0
                if name == "update":
                    self.steps.append(dict(self._cur))
                    self._cur = {}
                return out
            return wrapper

        for name, fn in self.saved.items():
            setattr(cls, name, timed(name, fn))

        def counted(updater, *args, **kwargs):
            self.updates += 1
            return self.saved_call(updater, *args, **kwargs)

        mx.optimizer.Updater.__call__ = counted
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(mx.mod.Module, name, fn)
        mx.optimizer.Updater.__call__ = self.saved_call


def imagenet_run(prefix, extra=()):
    """train_imagenet.py with IMAGENET_ARGS (then ``extra``, whose
    options win) on the card: the Module it trained, the batch-end
    times of each epoch (Speedometer's calls, each after the metrics
    read the batch's outputs), the host split, the per-parameter updates
    and the script's log lines."""
    ep = tests_module("test_torch_example_port")
    ends = []
    speedometer = mx.callback.Speedometer.__call__

    def stamp(cb, param):
        ends.append((param.epoch, param.nbatch, time.monotonic()))
        return speedometer(cb, param)

    lines, root = _Lines(), logging.getLogger()
    saved_level = root.level
    root.addHandler(lines)
    root.setLevel(logging.INFO)
    mx.callback.Speedometer.__call__ = stamp
    try:
        with host_split() as split:
            mod = ep.run_train_imagenet(IMAGENET_ARGS + list(extra)
                                        + ["--model-prefix", prefix])
        torch.cuda.synchronize()
    finally:
        mx.callback.Speedometer.__call__ = speedometer
        root.removeHandler(lines)
        root.setLevel(saved_level)
    return mod, ends, split, lines.lines


def imagenet_row():
    """The script's run and its row: ms a step and images/s over the
    last epoch's batches (each batch's end read after the metrics
    fetched its outputs by value), the host's split, the per-parameter
    updates a step, peak memory, one profiled step of the trained
    Module (busy, idle, operations), the checks."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="imagenet_")
    prefix = os.path.join(tmp, "resnet50")
    mx.random.seed(0)
    zero_launches()
    t0 = time.monotonic()
    mod, ends, split, lines = imagenet_run(prefix)
    secs = time.monotonic() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    last = [t for e, _, t in ends if e == IMAGENET_EPOCHS - 1]
    if len(last) != IMAGENET_BATCHES:
        fail("imagenet: %d batch ends in the last epoch, not %d"
             % (len(last), IMAGENET_BATCHES))
    ms = (last[-1] - last[0]) / (len(last) - 1) * 1e3
    steps = IMAGENET_EPOCHS * IMAGENET_BATCHES
    host = {k: float(np.median([s.get(k, 0.0) for s in
                                split.steps[-IMAGENET_BATCHES:]])) * 1e3
            for k in ("forward", "backward", "update")}
    speed = [l for l in lines if "Speed:" in l]
    top5 = [l for l in speed if "top_k_accuracy_5=" in l]
    files = ["%s-symbol.json" % prefix] + ["%s-%04d.params" % (prefix, e + 1)
                                           for e in range(IMAGENET_EPOCHS)]
    missing = [f for f in files if not os.path.exists(f)]
    rng = np.random.RandomState(1)
    batch = mx.io.DataBatch(
        [mx.nd.array(rng.uniform(-1, 1, (IMAGENET_BATCH, 3, IMAGENET_SIDE,
                                         IMAGENET_SIDE))
                     .astype(np.float32), ctx=mx.gpu(0))],
        [mx.nd.array(rng.randint(0, IMAGENET_CLASSES, IMAGENET_BATCH)
                     .astype(np.float32), ctx=mx.gpu(0))])

    def step():
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    step()
    spans = device_spans(step)
    if not spans:
        fail("imagenet: the profiler saw no device time in a step")
    busy, window, heads = profile_summary(spans)
    loss = cross_entropy(mod, batch)
    log("[imagenet] %s: examples/image-classification/train_imagenet.py %s "
        "(ResNet-50 v1, fp32 with TF32 off, its synthetic batch): %d steps "
        "in %.1f s with the trace and checkpoints; the last epoch's %d "
        "batches (host clock, synchronised by value): %.3f ms a step, "
        "%.2f images/s" % (card(), " ".join(IMAGENET_ARGS), steps, secs,
                           IMAGENET_BATCHES, ms, IMAGENET_BATCH / ms * 1e3))
    log("[imagenet] %s: imagenet_resnet50_nag, host ms a step by stage "
        "(median of the last epoch, no sync inside a step): %s; "
        "per-parameter updates a step %.1f (%d in %d steps); peak device "
        "memory %.1f MB allocated" % (
            card(), ", ".join("%s %.3f" % kv for kv in host.items()),
            split.updates / max(1, len(split.steps)), split.updates,
            len(split.steps), peak / 1e6))
    log("[imagenet] %s: imagenet_resnet50_nag, one profiled step of the "
        "trained Module: device busy %.3f ms, idle share at most %.3f, %d "
        "device operations; most device time: %s" % (
            card(), busy, 1 - busy / window, len(spans), "; ".join(
                "%s %.3f ms" % (n[:70], t / 1e3) for n, t in heads)))
    for l in speed:
        log("[imagenet] the script: %s" % l)
    log("[imagenet] cross-entropy of a fresh batch after the run %.4f; "
        "flash-attention launches %s" % (loss, launches))
    shutil.rmtree(tmp, ignore_errors=True)
    if not np.isfinite(loss):
        fail("imagenet: the loss is not finite (%r)" % loss)
    if len(speed) != IMAGENET_EPOCHS or len(top5) != IMAGENET_EPOCHS:
        fail("imagenet: the Speedometer printed %d lines, %d with top-5"
             % (len(speed), len(top5)))
    if missing:
        fail("imagenet: no checkpoint files %s" % missing)
    if split.updates != len(split.steps) * len(mod._exec_group.param_names):
        fail("imagenet: %d per-parameter updates in %d steps"
             % (split.updates, len(split.steps)))
    if any(launches.values()):
        fail("imagenet: a flash-attention kernel launched: %s" % launches)
    row = dict(ms=ms, imgs_per_sec=IMAGENET_BATCH / ms * 1e3, busy_ms=busy,
               idle=1 - busy / window, ops=len(spans), peak_mb=peak / 1e6,
               host_ms=host, updates_per_step=split.updates
               / max(1, len(split.steps)), launches=launches, seconds=secs)
    del mod, batch
    free_card()
    return row


def phase_imagenet():
    """BASELINE config #4's one-device half: the script on the card, its
    row, then one NAG step of the net against the CPU."""
    t0 = time.monotonic()
    rows = {"imagenet_resnet50_nag": imagenet_row()}
    mod = resnet_module(2, mx.cpu())
    mx.random.seed(0)
    mod.init_params(initializer=mx.initializer.MSRAPrelu())
    params, aux = mod.get_params()
    resnet_step_check({k: v.asnumpy() for k, v in params.items()},
                      {k: v.asnumpy() for k, v in aux.items()},
                      optimizer="nag", tag="imagenet")
    log("[imagenet] the phase took %.1f s" % (time.monotonic() - t0))
    return rows


# ---------------------------------------------------------------------------
# optim: every optimizer on ResNet-50's parameter tree, card against CPU
# ---------------------------------------------------------------------------

OPTIM_BATCH, OPTIM_STEPS = 8, 3
OPTIM_COMMON = dict(learning_rate=0.01, wd=1e-4, clip_gradient=0.05,
                    rescale_grad=0.5)
OPTIM_EXTRA = {"sgd": dict(momentum=0.9), "nag": dict(momentum=0.9),
               "signum": dict(momentum=0.9, wd_lh=0.01),
               "rmsprop": dict(centered=True, clip_weights=2.0),
               "dcasgd": dict(momentum=0.9), "lbsgd": dict(momentum=0.9),
               "ftrl": dict(lamda1=1e-4)}
# each step's gradient is the batch's times this factor
OPTIM_GRAD_SCALE = (1.0, 0.5, -1.0)
# the card against the CPU after three steps from the same state, as
# relative L2: every parameter's weight and state (float32 elementwise
# arithmetic: fused multiply-adds on the card, the sign and threshold
# optimizers' ties at zero; LBSGD's norms reduced in another order)
OPTIM_TOL = 1e-5
OPTIM_MP = ("sgd", "nag", "adam")


def optim_tree():
    """ResNet-50 v1's parameters (Xavier after ``random.seed(0)``) and
    their gradients from one batch-8 backward on the card, on the host;
    and the parameter names by index."""
    mod = resnet_module(OPTIM_BATCH, mx.gpu(0))
    mx.random.seed(0)
    mod.init_params(initializer=mx.initializer.Xavier())
    mod.forward(resnet_batch(OPTIM_BATCH, mx.gpu(0), seed=2), is_train=True)
    mod.backward()
    g = mod._exec_group
    names = list(g.param_names)
    weights = [a[0].asnumpy() for a in g.param_arrays]
    grads = [a[0].asnumpy() for a in g.grad_arrays]
    del mod
    free_card()
    return names, weights, grads


def optim_run(name, ctx, names, weights, grads, dtype="float32",
              timed=False, **kw):
    """OPTIM_STEPS ``update_multi`` steps of optimizer ``name`` on
    ``ctx``: (weights, flat states, and with ``timed`` the card's busy
    ms of the last call (torch.profiler) and the host's ms of the
    second, after the card caught up: the first also makes the
    states)."""
    opt = mx.optimizer.create(
        name, param_idx2name=dict(enumerate(names)),
        **dict(OPTIM_COMMON, **dict(OPTIM_EXTRA.get(name, {}), **kw)))
    upd = mx.optimizer.get_updater(opt)
    ws = [mx.nd.array(w, ctx=ctx, dtype=dtype) for w in weights]
    gs = [mx.nd.array(g, ctx=ctx, dtype=dtype) for g in grads]
    busy_ms, host_ms = None, []
    for k, c in enumerate(OPTIM_GRAD_SCALE):
        step_g = [g * c for g in gs]
        triples = [(i, step_g[i], ws[i]) for i in range(len(ws))]
        if timed and k == len(OPTIM_GRAD_SCALE) - 1:
            spans = device_spans(lambda: upd.update_multi(triples), tries=1)
            busy_ms = busy_us([(a, b) for a, b, _ in spans]) / 1e3
            continue
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        upd.update_multi(triples)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    flat = []
    for i in range(len(ws)):
        st = upd.states.get(i)
        stack = [st] if not isinstance(st, (tuple, list)) else list(st)
        while stack:
            s = stack.pop(0)
            if isinstance(s, (tuple, list)):
                stack = list(s) + stack
            elif s is not None:
                flat.append(s.asnumpy().astype(np.float32))
    return ([w.asnumpy().astype(np.float32) for w in ws], flat, busy_ms,
            host_ms[-1])


def optim_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def optim_sgld(names, weights, grads):
    """SGLD on the card: the weights less the deterministic step are
    normal noise of variance lr (5 standard errors)."""
    cases = op_cases()
    lr = OPTIM_COMMON["learning_rate"]
    mx.random.seed(5)
    got, _, dev, host = optim_run("sgld", mx.gpu(0), names, weights, grads,
                                  timed=True)
    w = [x.astype(np.float64) for x in weights]
    wd = {i: OPTIM_COMMON["wd"] if n.endswith(("_weight", "_gamma")) else 0.0
          for i, n in enumerate(names)}
    noise_var = 0.0
    for c in OPTIM_GRAD_SCALE:
        for i in range(len(w)):
            gc = np.clip(OPTIM_COMMON["rescale_grad"] * c * grads[i],
                         -OPTIM_COMMON["clip_gradient"],
                         OPTIM_COMMON["clip_gradient"])
            w[i] = w[i] - lr / 2 * (gc + wd[i] * w[i])
        noise_var += lr
    # the noise of three steps sums to one normal of variance 3 lr, the
    # decay of the earlier noise (wd lr / 2 a step) aside
    noise = np.concatenate([(a - b).reshape(-1) for a, b in zip(got, w)])
    err_mean, err_var = cases.moment_errors(noise, 0.0, np.sqrt(noise_var))
    return err_mean, err_var, dev, host


def phase_optim():
    """Every registered optimizer on ResNet-50 v1's tree, three
    ``update_multi`` steps on the card and on the CPU from the same
    state; multi-precision on a bf16 copy; SGLD by its noise; a NAG
    Module restored from its optimizer states."""
    t0 = time.monotonic()
    names, weights, grads = optim_tree()
    log("[optim] ResNet-50 v1's tree: %d parameters, %d values; the "
        "gradients of one batch-%d backward on the card, times %s over the "
        "three steps; %s" % (len(names), sum(w.size for w in weights),
                             OPTIM_BATCH, OPTIM_GRAD_SCALE, OPTIM_COMMON))
    zero_launches()
    rows, bad = {}, []
    for name in sorted(mx.optimizer.Optimizer.opt_registry):
        if name == "sgld":
            continue
        cw, cs, dev, host = optim_run(name, mx.gpu(0), names, weights, grads,
                                      timed=True)
        pw, ps, _, _ = optim_run(name, mx.cpu(), names, weights, grads)
        err_w = max(optim_rel(a, b) for a, b in zip(cw, pw))
        err_s = max([optim_rel(a, b) for a, b in zip(cs, ps)] or [0.0])
        moved = sum(not np.array_equal(a, b) for a, b in zip(cw, weights))
        rows[name] = dict(device_ms=dev, host_ms=host, err_w=err_w,
                          err_s=err_s)
        log("[optim] %s: %-7s device busy %.3f ms, host %.3f ms an "
            "update_multi (%d parameters); card vs CPU after %d steps: worst weight "
            "%.3g, worst state %.3g (relative L2, bound %g); %d of %d "
            "weights moved" % (card(), name, dev, host, len(cw), OPTIM_STEPS,
                               err_w, err_s, OPTIM_TOL, moved, len(cw)))
        if len(cs) != len(ps) or max(err_w, err_s) > OPTIM_TOL or \
                moved < len(cw) // 2:
            bad.append(name)
        del cw, cs, pw, ps
    err_mean, err_var, dev, host = optim_sgld(names, weights, grads)
    rows["sgld"] = dict(device_ms=dev, host_ms=host)
    log("[optim] %s: sgld    device busy %.3f ms, host %.3f ms an "
        "update_multi; "
        "its noise after %d steps: mean %.2f and variance %.2f standard "
        "errors from N(0, %d lr)" % (card(), dev, host, OPTIM_STEPS,
                                     err_mean, err_var, OPTIM_STEPS))
    if max(err_mean, err_var) > 5:
        bad.append("sgld")
    bf16 = [w.astype(np.float32) for w in weights]
    for name in OPTIM_MP:
        cw, cs, dev, host = optim_run(name, mx.gpu(0), names, bf16, grads,
                                      dtype="bfloat16", timed=True,
                                      multi_precision=True)
        pw, ps, _, _ = optim_run(name, mx.cpu(), names, bf16, grads,
                                 dtype="bfloat16", multi_precision=True)
        err_s = max(optim_rel(a, b) for a, b in zip(cs, ps))
        ulps = max(float(np.max(np.abs(a - b) / np.maximum(
            np.abs(b) * 2.0 ** -7, 1e-30))) for a, b in zip(cw, pw))
        log("[optim] %s: %s multi_precision on bf16 weights: device busy "
            "%.3f ms, host %.3f ms an update_multi; float32 masters and states vs "
            "CPU %.3g (bound %g); bf16 weights at most %.3g of a bf16 ulp "
            "apart" % (card(), name, dev, host, err_s, OPTIM_TOL, ulps))
        rows[name + "_mp_bf16"] = dict(device_ms=dev, host_ms=host,
                                       err_s=err_s, ulps=ulps)
        if err_s > OPTIM_TOL or ulps > 1.0 or len(cs) != len(ps):
            bad.append(name + " mp")
    launches = read_launches()
    optim_restore_check()
    log("[optim] flash-attention launches %s; the phase took %.1f s"
        % (launches, time.monotonic() - t0))
    if bad:
        fail("optim: the card disagrees with the CPU for %s" % bad)
    if any(launches.values()):
        fail("optim: a flash-attention kernel launched: %s" % launches)
    return {"optim_resnet50_tree": dict(rows=rows, launches=launches)}


def optim_restore_check():
    """NAG through Module at batch 8 on the card (cuDNN deterministic):
    two steps, ``save_checkpoint(save_optimizer_states=True)``, a third
    step; ``Module.load(load_optimizer_states=True)`` then one step must
    give the third step's parameters bit for bit."""
    gpu = mx.gpu(0)
    tmp = tempfile.mkdtemp(prefix="optim_")
    prefix = os.path.join(tmp, "nag")
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    params = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
    try:
        batch = resnet_batch(OPTIM_BATCH, gpu, seed=3)
        mod = resnet_module(OPTIM_BATCH, gpu)
        mx.random.seed(0)
        mod.init_params(initializer=mx.initializer.MSRAPrelu())
        mod.init_optimizer(optimizer="nag", optimizer_params=dict(params))
        for _ in range(2):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        del mod
        back = mx.mod.Module.load(prefix, 2, load_optimizer_states=True,
                                  data_names=("data0",),
                                  label_names=("softmax_label",),
                                  context=gpu)
        back.bind(data_shapes=[("data0", (OPTIM_BATCH, 3, 224, 224))],
                  label_shapes=[("softmax_label", (OPTIM_BATCH,))])
        back.init_optimizer(optimizer="nag", optimizer_params=dict(params))
        back.forward(batch, is_train=True)
        back.backward()
        back.update()
        got = {k: v.asnumpy() for k, v in back.get_params()[0].items()}
        del back
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            saved
        shutil.rmtree(tmp, ignore_errors=True)
    differ = [k for k in want if not np.array_equal(want[k], got[k])]
    log("[optim] %s: a NAG Module restored from its optimizer states takes "
        "the next step bit for bit: %d of %d parameters differ"
        % (card(), len(differ), len(want)))
    if differ:
        fail("optim: the restored NAG step differs in %s" % differ[:3])
    free_card()


# ---------------------------------------------------------------------------
# random: the samplers on the card, and large_word_lm
# ---------------------------------------------------------------------------

RANDOM_N = 2 ** 20
RANDOM_SIGMA = 5      # the mean's and the variance's bound, standard errors
RANDOM_P = 1e-6       # the least p-value of a KS or chi-squared test
# each MOMENTS row's distribution in scipy.stats (the family's name:
# the rows ``_random_x``, ``_random_x_like`` and ``_sample_x`` share it)
RANDOM_DISTS = {
    "uniform": ("continuous", lambda st: st.uniform(loc=-1.0, scale=4.0)),
    "normal": ("continuous", lambda st: st.norm(loc=2.0, scale=0.5)),
    "gamma": ("continuous", lambda st: st.gamma(2.0, scale=1.5)),
    "exponential": ("continuous", lambda st: st.expon(scale=0.5)),
    "poisson": ("discrete", lambda st: st.poisson(3.0)),
    "negative_binomial": ("discrete", lambda st: st.nbinom(3, 0.4)),
    # mu 2, alpha 0.5: r = 1 / alpha = 2, p = r / (r + mu) = 0.5
    "generalized_negative_binomial": ("discrete",
                                      lambda st: st.nbinom(2, 0.5)),
    "randint": ("discrete", lambda st: st.randint(-3, 5)),
}
LWLM = REPO_ROOT / "examples" / "rnn" / "large_word_lm" / "train.py"
LWLM_GATE = 5000.0    # tests/test_examples.py's gate (uniform is 10,000)


def random_family(name):
    base = name.replace("_like", "").replace("_random_", "").replace(
        "_sample_", "")
    return RANDOM_DISTS[base]


def chi2_pvalue(x, dist):
    """The chi-squared test of integer draws against ``dist``'s pmf,
    the tails pooled until each cell expects at least 20."""
    from scipy import stats

    lo, hi = int(x.min()), int(x.max())
    ks = np.arange(lo, hi + 1)
    obs = np.bincount((x - lo).astype(np.int64), minlength=len(ks))
    exp = dist.pmf(ks) * x.size
    exp[0] += dist.cdf(lo - 1) * x.size
    exp[-1] += dist.sf(hi) * x.size
    cells_o, cells_e, acc_o, acc_e = [], [], 0.0, 0.0
    for o, e in zip(obs, exp):
        acc_o, acc_e = acc_o + o, acc_e + e
        if acc_e >= 20:
            cells_o.append(acc_o)
            cells_e.append(acc_e)
            acc_o = acc_e = 0.0
    if acc_e and cells_e:
        cells_o[-1] += acc_o
        cells_e[-1] += acc_e
    cells_e = np.array(cells_e) * (x.size / np.sum(cells_e))
    return float(stats.chisquare(cells_o, cells_e).pvalue)


def random_samplers():
    """Each MOMENTS row: 2^20 draws on the card, the mean and variance
    within RANDOM_SIGMA standard errors, KS (continuous) or chi-squared
    (discrete) against scipy.stats; returns the failures."""
    from scipy import stats

    cases = op_cases()
    gpu, bad = mx.gpu(0), []
    for name in sorted(cases.MOMENTS):
        _, mean, std, _ = cases.MOMENTS[name]
        mx.random.seed(13)
        x, dtype = cases.draw(mx, name, RANDOM_N, gpu)
        kind, make = random_family(name)
        dist = make(stats)
        ok = x.dtype == dtype and np.isfinite(x).all()
        err_mean, err_var = cases.moment_errors(x, mean, std) if ok \
            else (np.inf, np.inf)
        if kind == "continuous":
            p = float(stats.kstest(x.astype(np.float64), dist.cdf).pvalue)
        else:
            p = chi2_pvalue(x, dist) if np.array_equal(x, np.round(x)) \
                else 0.0
        log("[random] %s: %-44s mean %.5f (%.2f se), var %.5f (%.2f se), "
            "%s p %.3g" % (card(), name, x.mean(), err_mean, x.var(),
                           err_var, "KS" if kind == "continuous" else
                           "chi2", p))
        if not ok or max(err_mean, err_var) > RANDOM_SIGMA or p < RANDOM_P:
            bad.append(name)
    # the multinomial's frequencies against its probabilities
    probs = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    mx.random.seed(13)
    d = mx.nd._sample_multinomial(mx.nd.array(probs, ctx=gpu),
                                  shape=RANDOM_N).asnumpy()
    p = float(stats.chisquare(np.bincount(d, minlength=4),
                              probs.astype(np.float64)
                              / probs.astype(np.float64).sum()
                              * d.size).pvalue)
    log("[random] %s: _sample_multinomial %d draws from %s: chi2 p %.3g"
        % (card(), RANDOM_N, probs.tolist(), p))
    if d.dtype != np.int32 or p < RANDOM_P:
        bad.append("_sample_multinomial")
    return bad


def random_zipfian():
    """_sample_unique_zipfian at large_word_lm's range_max 10,000 and
    256 draws a row: unique in every row, and each class's inclusion
    frequency over 512 rows on the card within 5 binomial standard
    errors (plus a row) of the CPU's."""
    inc = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        mx.random.seed(17)
        z = mx.nd._sample_unique_zipfian(range_max=10000, shape=(512, 256),
                                         ctx=ctx).asnumpy()
        if z.shape != (512, 256) or z.dtype != np.int32 or \
                any(len(np.unique(r)) != 256 for r in z) or \
                z.min() < 0 or z.max() >= 10000:
            return "draws not unique in a row, out of range or misshapen"
        inc[str(ctx)] = np.bincount(z.reshape(-1), minlength=10000) / 512.0
    a, b = inc[str(mx.gpu(0))], inc[str(mx.cpu())]
    pbar = (a + b) / 2
    worst = float(np.max(np.abs(a - b) / (np.sqrt(2 * pbar * (1 - pbar)
                                                  / 512) + 1.0 / 512)))
    log("[random] %s: _sample_unique_zipfian (512, 256) of 10,000 classes: "
        "unique in every row; inclusion frequencies card vs CPU at most "
        "%.2f binomial standard errors (plus a row) apart" % (card(), worst))
    return None if worst <= 5 else "inclusion frequencies %.2f se apart" \
        % worst


def random_replays():
    """``_shuffle`` of 2^20 rows is a permutation; every sampler's draws
    after ``set_state(get_state())`` are the same bits."""
    gpu, bad = mx.gpu(0), []
    mx.random.seed(19)
    rows = mx.nd.arange(RANDOM_N, ctx=gpu).reshape((RANDOM_N, 1))
    s = mx.nd._shuffle(rows).asnumpy().reshape(-1)
    if not (np.array_equal(np.sort(s), np.arange(RANDOM_N))
            and not np.array_equal(s, np.arange(RANDOM_N))):
        bad.append("_shuffle")
    cases = op_cases()
    for name in sorted(cases.MOMENTS) + ["_shuffle"]:
        def draw():
            if name == "_shuffle":
                return mx.nd._shuffle(rows).asnumpy()
            return cases.draw(mx, name, 4096, gpu)[0]
        draw()
        state = mx.random.get_state()
        first = draw()
        mx.random.set_state(state)
        if not np.array_equal(first, draw()):
            bad.append(name + " replay")
    log("[random] %s: _shuffle of %d rows a permutation; set_state("
        "get_state()) replays every sampler bit for bit: %s"
        % (card(), RANDOM_N, "yes" if not bad else bad))
    return bad


def large_word_lm_run():
    """examples/rnn/large_word_lm/train.py at its defaults on the card:
    its imports renamed to the port, its ``mx.cpu()`` context the
    card's; returns the validation perplexities and the seconds."""
    src, n = re.subn(r"^(import|from) mxtpu\b", r"\1 mxtpu_torch",
                     LWLM.read_text(), flags=re.M)
    src, m = re.subn(r"\bctx = mx\.cpu\(\)", "ctx = mx.gpu(0)", src)
    if (n, m) != (2, 1):
        fail("random: %s has %d imports of the JAX package and %d CPU "
             "contexts, not 2 and 1" % (LWLM, n, m))
    mod = types.ModuleType("large_word_lm_port")
    mod.__file__ = str(LWLM)
    exec(compile(src, str(LWLM), "exec"), mod.__dict__)
    out, lines, root = io.StringIO(), _Lines(), logging.getLogger()
    saved = sys.argv, root.level
    root.addHandler(lines)
    root.setLevel(logging.INFO)
    sys.argv = [str(LWLM)]
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
        torch.cuda.synchronize()
    finally:
        sys.argv = saved[0]
        root.removeHandler(lines)
        root.setLevel(saved[1])
    secs = time.monotonic() - t0
    ppl = [float(x) for l in lines.lines
           for x in re.findall(r"full valid ppl ([0-9.]+)", l)]
    final = re.findall(r"^FINAL_VALID_PPL ([0-9.]+)", out.getvalue(), re.M)
    for l in lines.lines:
        log("[random] large_word_lm: %s" % l)
    return ppl, float(final[-1]) if final else float("nan"), secs


def phase_random():
    """The samplers on the card by distribution, the unique-zipfian
    draw against the CPU's, shuffles and replays; then large_word_lm."""
    t0 = time.monotonic()
    zero_launches()
    bad = random_samplers()
    z = random_zipfian()
    if z is not None:
        bad.append("_sample_unique_zipfian: " + z)
    bad += random_replays()
    rows = {"random_samplers": dict(launches=read_launches())}
    zero_launches()
    ppl, final, secs = large_word_lm_run()
    rows["large_word_lm"] = dict(launches=read_launches(), seconds=secs,
                                 ppl=ppl, final=final)
    log("[random] %s: examples/rnn/large_word_lm/train.py on the card at "
        "its defaults (3 epochs, 256 sampled negatives of 10,000 words): "
        "%.1f s; validation perplexity by epoch %s, FINAL_VALID_PPL %.2f "
        "(the JAX package's gate %g)" % (card(), secs, ppl, final,
                                        LWLM_GATE))
    log("[random] flash-attention launches %s; the phase took %.1f s"
        % ({k: r["launches"] for k, r in rows.items()},
           time.monotonic() - t0))
    if bad:
        fail("random: failed %s" % bad)
    if not (len(ppl) == 3 and ppl[0] > ppl[2] and final < LWLM_GATE):
        fail("random: large_word_lm's perplexities %s, final %s"
             % (ppl, final))
    for name, r in rows.items():
        if any(r["launches"].values()):
            fail("random: %s launched a flash-attention kernel: %s"
                 % (name, r["launches"]))
    return rows


# ---------------------------------------------------------------------------
# gan: the DCGAN at its published widths through gluon, and the
# examples on Conv2DTranspose
# ---------------------------------------------------------------------------

GAN_BATCH, GAN_ITERS, GAN_WARM = 128, 30, 2
GAN_SEED = 0          # the real images and the noise, drawn with numpy
GAN_POOL = 4          # real batches, used in turn
GAN_SPLIT = 5         # iterations in the host's split
GAN_CHECK_BATCH = 8
# one batch-8 iteration on the card against the CPU from the same
# weights, images and noise (relative L2 of each group): float32 with
# TF32 off through ten convolutions and transposed convolutions, six
# batch norms and Adam's first step, which divides each gradient by its
# own size (tests/test_torch_dcgan.py holds the port's CPU to mxtpu's
# within the same bound)
GAN_CPU_TOL = 1e-4
GAN_EXAMPLES = (("gan/dcgan_mnist.py", ()),
                ("autoencoder/conv_autoencoder.py",
                 ("--epochs", "2", "--batch-size", "64")),
                ("fcn-xs/fcn_mini.py", ("--epochs", "5")),
                ("vae-gan/vae_gan_mini.py", ("--epochs", "1")))
GAN_RECON_GATE = 0.2  # tests/test_examples.py's FINAL_PIXEL_RECON gate


def dcgan_module():
    """tests/test_torch_dcgan_net.py: the DCGAN's nets, Trainers,
    images and iteration, written against gluon (imports only
    numpy)."""
    return tests_module("test_torch_dcgan_net")


def example_module(relpath, phase):
    """examples/<relpath> as a module of the port, as a user would run
    it on the card: its imports renamed, ``mx.tpu()``/``num_tpus()``
    made ``mx.gpu()``/``num_gpus()`` and its ``mx.cpu()`` contexts the
    card's."""
    path = REPO_ROOT / "examples" / relpath
    src, n = re.subn(r"^(import|from) mxtpu\b", r"\1 mxtpu_torch",
                     path.read_text(), flags=re.M)
    if n < 1:
        fail("%s: %s imports no JAX package to rename" % (phase, path))
    for old, new in (("tpu()", "gpu()"), ("num_tpus()", "num_gpus()"),
                     ("cpu()", "gpu(0)")):
        src = src.replace("mx." + old, "mx." + new)
    mod = types.ModuleType(path.stem + "_port")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def example_run(relpath, args, phase):
    """examples/<relpath> (``example_module``) run on the card: its
    ``main()`` with ``args``, ending on its own assertions.  Returns
    (its standard output, its log lines, seconds)."""
    path = REPO_ROOT / "examples" / relpath
    mod = example_module(relpath, phase)
    out, lines, root = io.StringIO(), _Lines(), logging.getLogger()
    saved = sys.argv, root.level
    root.addHandler(lines)
    root.setLevel(logging.INFO)
    sys.argv = [str(path)] + list(args)
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
        torch.cuda.synchronize()
    except AssertionError as e:
        fail("%s: %s %s: its own assertion failed: %s"
             % (phase, relpath, " ".join(args), e))
    finally:
        sys.argv = saved[0]
        root.removeHandler(lines)
        root.setLevel(saved[1])
    secs = time.monotonic() - t0
    for line in lines.lines[-4:] + out.getvalue().splitlines()[-2:]:
        log("[%s] %s: %s" % (phase, relpath, line))
    return out.getvalue(), lines.lines, secs


class _Ranged(object):
    """A block called inside a torch.profiler range of its name."""

    def __init__(self, block, name):
        self.block, self.name = block, name

    def __call__(self, *args):
        with torch.profiler.record_function(self.name):
            return self.block(*args)


def gan_profile(fn):
    """fn() under torch.profiler, the generator's calls inside ranges
    named "generator": (the device operations' spans, the device us of
    the convolution kernels launched by the generator's ops, forward
    and backward, or None when the profiler linked no kernel to an
    op).  The generator holds no convolution but its transposed ones,
    so those kernels are theirs; the backward's are found by the
    autograd nodes' sequence numbers, which their forward ops carry."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.name != "generator"]

    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    fwd_seq = {e.sequence_nr for e in cpu if e.sequence_nr >= 0 and any(
        a.name == "generator" for a in ancestors(e))}

    def in_generator(e):
        return any(a.name == "generator" or (
            a.name.startswith("autograd::engine::evaluate_function")
            and a.sequence_nr in fwd_seq) for a in ancestors(e))

    linked, conv_us = 0, 0.0
    for e in cpu:
        for k in e.kernels:
            linked += 1
            if kind_of(k.name) == "convolution" and in_generator(e):
                conv_us += k.duration
    return spans, (conv_us if linked else None)


def dcgan_flops(dcgan, batch):
    """An iteration's operations (two a multiply-add) in the nets'
    convolutions: each layer's multiply-adds (its output's pixels for a
    convolution, its input's for a transposed one, times C_in C_out
    k^2, k = 4) run 9 times in D (3 forwards; the data and weight
    gradients of 3 backwards) and 4 times in G (2 forwards; 1
    backward, whose input z takes no gradient)."""
    side, nz, g, d = dcgan.SIDE, dcgan.NZ, dcgan.NGF, dcgan.NDF
    gen = zip((1,) + tuple(side // 2 ** k for k in (4, 3, 2, 1)),
              (nz, 8 * g, 4 * g, 2 * g, g), (8 * g, 4 * g, 2 * g, g, 3))
    dis = zip(tuple(side // 2 ** k for k in (1, 2, 3, 4)) + (1,),
              (3, d, 2 * d, 4 * d, 8 * d), (d, 2 * d, 4 * d, 8 * d, 1))
    macs = [sum(px * px * ci * co * 16 for px, ci, co in layers)
            for layers in (gen, dis)]
    return 2 * batch * (4 * macs[0] + 9 * macs[1])


def gan_host_split(dcgan, nets, steppers, loss_fn, real, z):
    """The host's ms an iteration in each stage (D's forward and
    backward, its update, G's, its update): the host clock at each
    stage's end, no sync inside an iteration and one after it; the
    median over GAN_SPLIT iterations."""
    times = []
    for _ in range(GAN_SPLIT):
        t = [time.perf_counter()]
        dcgan.iteration(mx, nets, steppers, loss_fn, real, z,
                        mark=lambda stage: t.append(time.perf_counter()))
        torch.cuda.synchronize()
        times.append(np.diff(t) * 1e3)
    return dict(zip(("d", "d_update", "g", "g_update"),
                    np.median(np.array(times), axis=0).tolist()))


def gan_cpu_check(dcgan):
    """One iteration at GAN_CHECK_BATCH on the card and on the CPU from
    the card's initial weights and the same images and noise: each
    group's relative L2 (GAN_CPU_TOL) and the losses'."""
    from mxtpu_torch.gluon.parameter import load_numpy

    real = dcgan.real_images(GAN_CHECK_BATCH, seed=GAN_SEED + 50)
    z = dcgan.noise(GAN_CHECK_BATCH, seed=GAN_SEED + 51)
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    weights, res = None, []
    for ctx in (mx.gpu(0), mx.cpu()):
        nets = dcgan.build(mx, ctx)
        with mx.autograd.pause():
            nets[1](nets[0](mx.nd.array(z, ctx=ctx)))
        if weights is None:
            weights = {k: p.data().asnumpy() for net in nets
                       for k, p in net.collect_params().items()}
        else:
            for net in nets:
                load_numpy(net.collect_params(), {
                    k: weights[k] for k in net.collect_params().keys()})
        steppers = dcgan.trainers(mx, *nets)
        d, g = dcgan.iteration(mx, nets, steppers, loss_fn,
                               mx.nd.array(real, ctx=ctx),
                               mx.nd.array(z, ctx=ctx))
        res.append((np.concatenate([d.asnumpy(), g.asnumpy()]),
                    dcgan.state(nets)))
    (card_loss, card_state), (cpu_loss, cpu_state) = res
    errs = {"losses": op_rel_l2(card_loss, cpu_loss)}
    for group in card_state:
        keys = sorted(card_state[group])
        errs[group] = op_rel_l2(
            np.concatenate([card_state[group][k].ravel() for k in keys]),
            np.concatenate([cpu_state[group][k].ravel() for k in keys]))
    return errs


def gan_row(dcgan):
    """The DCGAN at nz 100, ngf = ndf = 64, 64 x 64 x 3, batch 128:
    GAN_ITERS iterations (GAN_WARM warm), then the host's split and one
    profiled iteration."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    gpu = mx.gpu(0)
    t0 = time.monotonic()
    nets = dcgan.build(mx, gpu)
    steppers = dcgan.trainers(mx, *nets)
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    pool = [mx.nd.array(dcgan.real_images(GAN_BATCH, seed=GAN_SEED + i),
                        ctx=gpu) for i in range(GAN_POOL)]
    zs = [mx.nd.array(dcgan.noise(GAN_BATCH, seed=GAN_SEED + 100 + i),
                      ctx=gpu) for i in range(GAN_ITERS)]
    setup_s = time.monotonic() - t0
    losses = []

    def run(i):
        d, g = dcgan.iteration(mx, nets, steppers, loss_fn,
                               pool[i % GAN_POOL], zs[i])
        losses.append((d.mean(), g.mean()))

    zero_launches()
    t0 = time.monotonic()
    for i in range(GAN_WARM):
        run(i)
    float(losses[-1][1].asnumpy())
    first_s = time.monotonic() - t0
    t1 = time.perf_counter()
    for i in range(GAN_WARM, GAN_ITERS):
        run(i)
    float(losses[-1][1].asnumpy())
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    vals = np.array([[float(d.asnumpy()), float(g.asnumpy())]
                     for d, g in losses])
    host = gan_host_split(dcgan, nets, steppers, loss_fn, pool[0], zs[0])
    ranged = (_Ranged(nets[0], "generator"), nets[1])
    spans, conv_us = gan_profile(lambda: dcgan.iteration(
        mx, ranged, steppers, loss_fn, pool[1], zs[1]))
    if not spans:
        fail("gan: the profiler saw no device time in an iteration")
    busy, window, heads = profile_summary(spans, top=8)
    idle, ops = 1 - busy / window, len(spans)
    kinds = sorted(by_kind(spans).items(), key=lambda kv: -kv[1])
    timed = GAN_ITERS - GAN_WARM
    ms = wall / timed * 1e3
    ips = GAN_BATCH / ms * 1e3
    share = None if conv_us is None else conv_us / 1e3 / busy
    flops = dcgan_flops(dcgan, GAN_BATCH)
    bound, bound_by = bound_ms(0, flops, torch.float32)
    log("[gan] %s: gan_dcgan64 (DCGAN, nz %d, ngf = ndf = %d, %dx%dx3, "
        "batch %d, both nets hybridized without biases, Adam lr %g beta1 "
        "%g, fp32 with TF32 off): %d timed iterations after %d warm "
        "(%.1f s with the set-up's %.1f): %.3f ms an iteration, %.2f "
        "images/s (host clock, synchronised by value; an iteration is a D "
        "step on a real and a fake batch and a G step)"
        % (card(), dcgan.NZ, dcgan.NGF, dcgan.SIDE, dcgan.SIDE, GAN_BATCH,
           dcgan.LR, dcgan.BETA1, timed, GAN_WARM, first_s, setup_s, ms,
           ips))
    log("[gan] %s: gan_dcgan64's bound: %.1f GFLOP an iteration in its "
        "convolutions (dcgan_flops) at 67 TFLOP/s (fp32): %.3f ms (%s); "
        "busy is %.2fx it" % (card(), flops / 1e9, bound, bound_by,
                              busy / bound))
    log("[gan] %s: gan_dcgan64, one profiled iteration: device busy %.3f "
        "ms, idle share at most %.3f, %d device operations; the "
        "transposed convolutions' kernels %s; peak device memory %.1f MB "
        "allocated; by kind: %s; most device time: %s"
        % (card(), busy, idle, ops,
           "not measured (the profiler linked no kernel to an op)"
           if share is None else "%.3f ms, %.3f of busy" % (conv_us / 1e3,
                                                            share),
           peak / 1e6, "; ".join("%s %.3f ms" % (k, t / 1e3)
                                 for k, t in kinds),
           "; ".join("%s %.3f ms" % (n[:70], t / 1e3) for n, t in heads)))
    log("[gan] %s: gan_dcgan64, host ms an iteration by stage (median of "
        "%d, no sync inside an iteration): %s; their sum %.3f ms"
        % (card(), GAN_SPLIT, ", ".join("%s %.3f" % kv for kv in
                                         host.items()), sum(host.values())))
    log("[gan] gan_dcgan64: D's and G's mean losses by iteration: %s"
        % " ".join("%.4f/%.4f" % tuple(v) for v in vals))
    if not np.isfinite(vals).all():
        fail("gan: a loss is not finite: %s" % vals.tolist())
    if any(launches.values()):
        fail("gan: a flash-attention kernel launched: %s" % launches)
    result = dict(ms=ms, imgs_per_sec=ips, busy_ms=busy, idle=idle, ops=ops,
                  peak_mb=peak / 1e6, launches=launches, host_ms=host,
                  bound_ms=bound,
                  deconv_ms=None if conv_us is None else conv_us / 1e3,
                  deconv_share=share, losses=vals[-1].tolist())
    del nets, steppers, losses, pool, zs
    free_card()
    return result


def phase_gan():
    """The DCGAN row, its batch-8 iteration against the CPU, and the
    four examples on Conv2DTranspose; returns the rows."""
    t0 = time.monotonic()
    dcgan = dcgan_module()
    rows = {"gan_dcgan64": gan_row(dcgan)}
    errs = gan_cpu_check(dcgan)
    log("[gan] %s: one iteration at batch %d (full width) on the card "
        "against the CPU from the same weights, images and noise, "
        "relative L2 (bound %g): %s"
        % (card(), GAN_CHECK_BATCH, GAN_CPU_TOL,
           ", ".join("%s %.3g" % kv for kv in errs.items())))
    if not max(errs.values()) <= GAN_CPU_TOL:
        fail("gan: the batch-%d iteration is %s from the CPU's (bound %g)"
             % (GAN_CHECK_BATCH, errs, GAN_CPU_TOL))
    zero_launches()
    secs = {}
    for relpath, args in GAN_EXAMPLES:
        out, lines, secs[relpath] = example_run(relpath, args, "gan")
        if relpath.startswith("vae-gan"):
            recon = re.findall(r"^FINAL_PIXEL_RECON ([0-9.]+)", out, re.M)
            if not recon or not float(recon[-1]) < GAN_RECON_GATE:
                fail("gan: %s's FINAL_PIXEL_RECON %s, not under %g"
                     % (relpath, recon, GAN_RECON_GATE))
    rows["gan_examples"] = dict(launches=read_launches(), seconds=secs)
    log("[gan] %s: the examples on the card, each to its end and its own "
        "assertions: %s; flash-attention launches %s; the phase took "
        "%.1f s" % (card(), ", ".join("%s %.1f s" % kv for kv in
                                      secs.items()),
                    {k: r["launches"] for k, r in rows.items()},
                    time.monotonic() - t0))
    if any(rows["gan_examples"]["launches"].values()):
        fail("gan: the examples launched a flash-attention kernel")
    return rows


# ---------------------------------------------------------------------------
# seq: CTC at a character alphabet's size, the CTC and SVM examples,
# the recurrent cells at word_lm's widths and the linalg ops
# ---------------------------------------------------------------------------

CTC_SHAPE = (200, 32, 29)     # T, N, C: a character alphabet and blank
CTC_LABELS = (20, 80)         # label lengths, drawn from the seed
CTC_FRAMES = (150, 200)       # data lengths, drawn from the seed
# the card against the CPU (relative): each feasible row's cost and the
# gradient of its frames (F.ctc_loss's forward variables run up to
# about T log C = 670 nats in float32, where one ulp is 6.1e-5: the
# gradient's exponentials of their differences carry that relative
# error; five ulps); the infeasible row's cost (about 1e5) and its
# gradient, float32 rounding at that magnitude (tests/test_torch_ctc.py)
CTC_TOL = dict(loss=1e-5, grad=3e-4, infeasible_loss=1e-6,
               infeasible_grad=2e-2)
CTC_CASES = (("first", True), ("last", True), ("first", False))
SEQ_EXAMPLES = (("ctc/ocr_ctc.py", ("--epochs", "8")),
                ("speech_recognition/speech_ctc.py", ("--epochs", "12")),
                ("svm_mnist/svm_mnist.py", ("--epochs", "3")))
# tests/test_examples.py's gate on speech_ctc.py (all blank: 1.0) is a
# draw of the initial weights: on the CPU mxtpu meets it at 2 of 5
# seeds (its default 5 among them), the port at 2 of 8 (not at 5), and
# the port from mxtpu's seed-5 weights follows mxtpu's losses to four
# places for 12 epochs and ends at 0.110 (mxtpu 0.145).  So it is
# printed, and the run is held by its loss falling and by
# speech_check: the example's loop from one draw of weights on the
# card against the CPU, SPEECH_STEPS steps, each loss within
# SPEECH_CPU_TOL (relative; the CTC gradients' CTC_TOL carried through
# Adam)
SPEECH_LER_GATE = 0.6
SPEECH_SEED, SPEECH_STEPS, SPEECH_CPU_TOL = 5, 60, 1e-3
# gluon.rnn.LSTMCell unrolled against gluon.rnn.LSTM at word_lm's
# widths (WORD_LM: 2 x 650, bptt 35, batch 32), relative L2 of the
# outputs and of every gradient
LSTM_CELL_TOL = 1e-5
LINALG_BATCH, LINALG_N = 16, 64
# each linalg op on the card against the CPU (relative L2 of its
# outputs and of its inputs' gradients; TF32 off): cuSOLVER's and
# LAPACK's factorizations round apart by the conditioning (at most
# about 20 here)
LINALG_TOL = 1e-4


def ctc_case(blank, label_lengths, seed, infeasible=True):
    """(data, label, data lengths, label lengths, attrs) at CTC_SHAPE,
    drawn from ``seed``; row 0 has fewer frames than labels when
    ``infeasible``."""
    t, n, c = CTC_SHAPE
    rng = np.random.RandomState(seed)
    data = rng.normal(0, 1, CTC_SHAPE).astype(np.float32)
    llen = rng.randint(CTC_LABELS[0], CTC_LABELS[1] + 1, n)
    dlen = rng.randint(CTC_FRAMES[0], CTC_FRAMES[1] + 1, n)
    if infeasible:
        dlen[0] = llen[0] - 5
    lo, hi, pad = (1, c, 0) if blank == "first" else (0, c - 1, c - 1)
    label = rng.randint(lo, hi, (n, CTC_LABELS[1]))
    label[np.arange(CTC_LABELS[1])[None, :] >= llen[:, None]] = pad
    attrs = dict(blank_label=blank, use_data_lengths=True,
                 use_label_lengths=label_lengths)
    return (data, label.astype(np.float32), dlen.astype(np.float32),
            llen.astype(np.float32), attrs)


def ctc_run(case, ctx):
    """(the costs, the data's gradient of their sum) on ``ctx``."""
    data, label, dlen, llen, attrs = case
    device = ctx.torch_device
    x = torch.tensor(data, device=device, requires_grad=True)
    extra = [torch.tensor(dlen, device=device)]
    if attrs["use_label_lengths"]:
        extra.append(torch.tensor(llen, device=device))
    op = mx.ops.registry.get_op("CTCLoss")
    loss = op.fn(x, torch.tensor(label, device=device), *extra, **attrs)
    loss.sum().backward()
    return loss.detach().cpu().numpy(), x.grad.cpu().numpy()


def ctc_check():
    """CTC on the card against the CPU under both blank conventions,
    with the infeasible row; and its ms of forward and backward, with
    and without that row."""
    worst = {k: 0.0 for k in CTC_TOL}
    for k, (blank, label_lengths) in enumerate(CTC_CASES):
        case = ctc_case(blank, label_lengths, seed=k)
        (gl, gg), (cl, cg) = ctc_run(case, mx.gpu(0)), ctc_run(case, mx.cpu())
        if not (np.isfinite(gl).all() and np.isfinite(gg).all()):
            fail("seq: CTC (%s) not finite on the card" % blank)
        for row in range(CTC_SHAPE[1]):
            pre = "infeasible_" if row == 0 else ""
            errs = {pre + "loss": abs(gl[row] - cl[row]) / abs(cl[row]),
                    pre + "grad": op_rel_l2(gg[:, row], cg[:, row])}
            for key, err in errs.items():
                worst[key] = max(worst[key], err)
        if not 9e4 < gl[0] < 2e5:
            fail("seq: the infeasible row's cost %g is not the reference's "
                 "log_epsilon cost" % gl[0])
    log("[seq] %s: CTCLoss at (T, N, C) %s, label lengths %d-%d, data "
        "lengths %d-%d, row 0 infeasible, under %s: the card against the "
        "CPU, the worst relative error of each against its bound: %s"
        % (card(), CTC_SHAPE, CTC_LABELS[0], CTC_LABELS[1], CTC_FRAMES[0],
           CTC_FRAMES[1], ", ".join("%s (label lengths %s)" % c
                                    for c in CTC_CASES),
           ", ".join("%s %.3g (%g)" % (k, worst[k], CTC_TOL[k])
                     for k in CTC_TOL)))
    bad = {k: v for k, v in worst.items() if not v <= CTC_TOL[k]}
    if bad:
        fail("seq: CTC on the card is off the CPU's: %s" % bad)
    ms = {}
    for infeasible in (False, True):
        case = ctc_case("first", True, seed=7, infeasible=infeasible)
        ms[infeasible] = time_ms(lambda: ctc_run(case, mx.gpu(0)), 10)
    log("[seq] %s: seq_ctc: forward and backward at %s, host clock around "
        "10 calls (CUDA events): %.3f ms with every row feasible "
        "(F.ctc_loss), %.3f ms with the infeasible row (its recursion, %d "
        "steps)" % (card(), CTC_SHAPE, ms[False], ms[True], CTC_SHAPE[0]))
    return dict(ms=ms[False], ms_infeasible=ms[True], worst=worst)


def lstm_cell_check():
    """A 2-layer LSTMCell stack unrolled over bptt 35, batch 32, width
    650 against gluon.rnn.LSTM from the same weights: outputs and the
    gradients of the data and of every weight; each one's ms of forward
    and backward."""
    from mxtpu_torch.gluon.parameter import load_numpy

    gpu = mx.gpu(0)
    h, t, n = WORD_LM["width"], 35, 32
    with mx.sym.NameManager():
        layer = mx.gluon.rnn.LSTM(h, num_layers=2, input_size=h)
        cell = mx.gluon.rnn.SequentialRNNCell()
        with cell.name_scope():
            for i in range(2):
                cell.add(mx.gluon.rnn.LSTMCell(h, input_size=h,
                                               prefix="l%d_" % i))
    rng = np.random.RandomState(0)
    weights = {k: rng.uniform(-0.1, 0.1, p.shape).astype(np.float32)
               for k, p in layer.collect_params().items()}
    for block, prefix in ((layer, layer.prefix), (cell, cell.prefix)):
        block.initialize(ctx=gpu)
        load_numpy(block.collect_params(), {
            prefix + k[len(layer.prefix):]: v for k, v in weights.items()})
    x = rng.uniform(-1, 1, (t, n, h)).astype(np.float32)
    head = rng.normal(0, 1, (t, n, h)).astype(np.float32)

    def run(fn, block):
        xa = mx.nd.array(x, ctx=gpu)
        xa.attach_grad()
        with mx.autograd.record():
            out = fn(xa)
        out.backward(mx.nd.array(head, ctx=gpu))
        grads = [xa.grad.asnumpy()] + [
            block.collect_params()[k].grad().asnumpy()
            for k in sorted(block.collect_params().keys())]
        return out.asnumpy(), grads

    fused = lambda xa: layer(xa)
    unrolled = lambda xa: cell.unroll(t, xa, layout="TNC",
                                      merge_outputs=True)[0]
    res = [run(fused, layer), run(unrolled, cell)]
    errs = [op_rel_l2(res[1][0], res[0][0])] + [
        op_rel_l2(a, b) for a, b in zip(res[1][1], res[0][1])]
    ms = {}
    for name, fn, block in (("fused", fused, layer),
                            ("unrolled", unrolled, cell)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run(fn, block)
        ms[name] = (time.perf_counter() - t0) / 5 * 1e3
    log("[seq] %s: seq_lstm_cell: gluon.rnn.LSTMCell x 2 unrolled over "
        "(%d, %d, %d) against gluon.rnn.LSTM(%d, num_layers=2) from the "
        "same weights: the outputs %.3g, the data's gradient %.3g, the "
        "worst weight's gradient %.3g (relative L2, bound %g); forward "
        "and backward %.3f ms fused, %.3f ms unrolled (host clock, "
        "synchronised by value)"
        % (card(), t, n, h, h, errs[0], errs[1], max(errs[2:]),
           LSTM_CELL_TOL, ms["fused"], ms["unrolled"]))
    if not max(errs) <= LSTM_CELL_TOL:
        fail("seq: the unrolled LSTMCell is %g from the fused LSTM"
             % max(errs))
    return dict(ms=ms["unrolled"], ms_fused=ms["fused"], worst=max(errs))


def linalg_inputs():
    """(op, inputs, attrs, canon) for every linalg op at LINALG_BATCH
    matrices of LINALG_N x LINALG_N."""
    b, n = LINALG_BATCH, LINALG_N
    rng = np.random.RandomState(0)
    m = [rng.uniform(-1, 1, (b, n, n)) for _ in range(3)]
    spd = m[0] @ m[0].transpose(0, 2, 1) / n + np.eye(n)
    low = np.linalg.cholesky(spd)
    gen = np.eye(n) + 0.05 * m[1]
    # eigenvalues 1..n, a unit apart: eigenvectors as well-conditioned
    # as the values (an eigenvector moves by the rounding over the gap
    # to its neighbours; spd's gaps go down to about 1e-3)
    q = np.linalg.qr(m[2])[0]
    spaced = q @ (np.arange(1.0, n + 1)[:, None] * q.transpose(0, 2, 1))
    cases = op_cases()
    f = lambda *xs: [x.astype(np.float32) for x in xs]
    return [
        ("_linalg_gemm", f(m[0], m[1], m[2]), dict(alpha=0.5, beta=2.0),
         None),
        ("_linalg_gemm2", f(m[0], m[1]), dict(transpose_b=True), None),
        ("_linalg_potrf", f(spd), {}, None),
        ("_linalg_potri", f(low), {}, None),
        ("_linalg_trmm", f(low, m[1]), dict(alpha=2.0), None),
        ("_linalg_trsm", f(low, m[1]), dict(transpose=True), None),
        ("_linalg_sumlogdiag", f(spd), {}, None),
        ("_linalg_syrk", f(m[0]), dict(alpha=0.5), None),
        ("_linalg_gelqf", f(m[0]), {}, cases.sign_lq),
        ("_linalg_syevd", f(spaced), {}, cases.sign_rows),
        ("_linalg_makediag", f(m[0][:, 0]), {}, None),
        ("_linalg_extractdiag", f(m[0]), dict(offset=1), None),
        ("_linalg_inverse", f(gen), {}, None),
        ("_linalg_det", f(gen), {}, None),
        ("_linalg_slogdet", f(gen), {}, None),
        ("_contrib_fft", f(m[0]), {}, None),
        ("_contrib_ifft", f(np.concatenate([m[0], m[1]], -1)), {}, None)]


def linalg_check():
    """Every linalg op on the card against the CPU: outputs (sign-free
    for gelqf and syevd), and the inputs' gradients of a random-weighted
    sum of the outputs where the outputs carry no sign of their own."""
    reg = mx.ops.registry
    worst, by_op = 0.0, {}
    for name, inputs, attrs, canon in linalg_inputs():
        res = []
        for device in (mx.gpu(0).torch_device, torch.device("cpu")):
            xs = [torch.tensor(x, device=device, requires_grad=canon is None)
                  for x in inputs]
            out = reg.get_op(name).fn(*xs, **attrs)
            outs = list(out) if isinstance(out, tuple) else [out]
            got = [o.detach().cpu().numpy() for o in outs]
            grads = []
            if canon is None:
                heads = [torch.tensor(np.random.RandomState(7 + k).normal(
                    0, 1, o.shape).astype(np.float32), device=device)
                    for k, o in enumerate(outs)]
                grads = [g.cpu().numpy() for g in torch.autograd.grad(
                    [o for o in outs if o.requires_grad],
                    xs, [h for o, h in zip(outs, heads)
                         if o.requires_grad])]
            res.append(((canon or (lambda v: v))(got), grads))
        errs = [op_rel_l2(a, b) for a, b in zip(res[0][0] + res[0][1],
                                             res[1][0] + res[1][1])]
        by_op[name] = max(errs)
        worst = max(worst, by_op[name])
    top = max(by_op, key=by_op.get)
    log("[seq] %s: seq_linalg: %d linalg ops at %d matrices of %dx%d on "
        "the card against the CPU, outputs and gradients: the worst "
        "relative L2 %.3g in %s (bound %g)"
        % (card(), len(by_op), LINALG_BATCH, LINALG_N, LINALG_N, worst,
           top, LINALG_TOL))
    bad = {k: v for k, v in by_op.items() if not v <= LINALG_TOL}
    if bad:
        fail("seq: linalg ops off the CPU's: %s" % bad)
    return dict(worst=worst, worst_op=top, ops=len(by_op))


def speech_check():
    """speech_ctc.py's model and loop (its ``AcousticModel``,
    ``make_batch``, Adam lr 5e-3 over the batch mean) on the card and
    on the CPU from the card's seed-5 draw of the weights and the same
    batches: the largest relative difference of a step's loss."""
    from mxtpu_torch.gluon.parameter import load_numpy

    mod = example_module("speech_recognition/speech_ctc.py", "seq")
    weights, runs = None, []
    for ctx in (mx.gpu(0), mx.cpu()):
        mx.random.seed(SPEECH_SEED)
        with mx.sym.NameManager():
            model = mod.AcousticModel()
        model.initialize(ctx=ctx)
        model(mx.nd.zeros((2, mod.MAX_T, mod.N_BANDS), ctx=ctx))
        if weights is None:
            weights = {k: p.data().asnumpy()
                       for k, p in model.collect_params().items()}
        else:
            load_numpy(model.collect_params(), weights)
        trainer = mx.gluon.Trainer(model.collect_params(), "adam",
                                   {"learning_rate": 5e-3})
        rng, losses = np.random.RandomState(SPEECH_SEED), []
        for _ in range(SPEECH_STEPS):
            x, y, _, ylen = mod.make_batch(rng, 16)
            with mx.autograd.record():
                loss = mx.nd.CTCLoss(
                    model(mx.nd.array(x, ctx=ctx)), mx.nd.array(y, ctx=ctx),
                    mx.nd.array(ylen, ctx=ctx),
                    use_label_lengths=True).mean()
            loss.backward()
            trainer.step(1)
            losses.append(loss)
        runs.append(np.array([float(l.asnumpy()) for l in losses]))
    return float((np.abs(runs[0] - runs[1]) / np.abs(runs[1])).max()), runs


def phase_seq():
    """CTC, the CTC and SVM examples, the recurrent cells and the
    linalg ops on the card; returns the rows."""
    t0 = time.monotonic()
    rows = {}
    zero_launches()
    rows["seq_ctc"] = dict(ctc_check(), launches=read_launches())
    zero_launches()
    secs, ler = {}, None
    for relpath, args in SEQ_EXAMPLES:
        out, lines, secs[relpath] = example_run(relpath, args, "seq")
        if relpath.startswith("speech"):
            ler = re.findall(r"^FINAL_LER ([0-9.]+)", out, re.M)
            losses = [float(x) for l in lines
                      for x in re.findall(r"ctc loss ([0-9.]+)", l)]
            if not (ler and len(losses) == int(args[-1])
                    and losses[-1] < losses[0]):
                fail("seq: %s: FINAL_LER %s, its losses by epoch %s"
                     % (relpath, ler, losses))
            ler = float(ler[-1])
    speech_err, speech_runs = speech_check()
    log("[seq] %s: speech_ctc.py's loop from one draw of the weights, %d "
        "steps on the card against the CPU: each step's loss within %.3g "
        "(relative, bound %g); the card's first, middle and last losses: "
        "%s" % (card(), SPEECH_STEPS, speech_err, SPEECH_CPU_TOL,
                ", ".join("%.4f" % speech_runs[0][i] for i in (
                    0, SPEECH_STEPS // 2, SPEECH_STEPS - 1))))
    if not speech_err <= SPEECH_CPU_TOL:
        fail("seq: speech_ctc.py's loop on the card is %g from the CPU's"
             % speech_err)
    rows["seq_examples"] = dict(launches=read_launches(), seconds=secs,
                                final_ler=ler, speech_cpu_err=speech_err)
    zero_launches()
    rows["seq_lstm_cell"] = dict(lstm_cell_check(), launches=read_launches())
    zero_launches()
    rows["seq_linalg"] = dict(linalg_check(), launches=read_launches())
    log("[seq] %s: the examples on the card: %s, speech_ctc.py's "
        "FINAL_LER %s (tests/test_examples.py's gate %g, a draw of the "
        "initial weights: SPEECH_LER_GATE); "
        "flash-attention launches %s; the phase took %.1f s"
        % (card(), ", ".join("%s %.1f s" % kv for kv in secs.items()), ler,
           SPEECH_LER_GATE, {k: r["launches"] for k, r in rows.items()},
           time.monotonic() - t0))
    for name, r in rows.items():
        if any(r["launches"].values()):
            fail("seq: %s launched a flash-attention kernel: %s"
                 % (name, r["launches"]))
    return rows


# ---------------------------------------------------------------------------
# cflow: the word LM written with sym.contrib.foreach at word_lm's
# widths, per step and captured, and the control-flow ops' cases
# ---------------------------------------------------------------------------

CFLOW_LM = dict(vocab=33278, width=650, layers=2)
CFLOW_BPTT, CFLOW_BATCH = 35, 32
CFLOW_LR = 1.0                # SGD on the mean loss
CFLOW_WARM, CFLOW_STEPS = 2, 20
CFLOW_K, CFLOW_CALLS = 8, 2   # fused: K steps a call, timed calls
# one step of the foreach graph against the fused RNN op's graph from
# the same weights on the card, fp32 with TF32 off (relative L2): the
# loop's products and cuDNN's fused LSTM sum in other orders
CFLOW_RNN_TOL = dict(loss=1e-5, grads=1e-4, weights=1e-5)
# the captured loop's weights after K steps against K per-step Module
# steps on the card (relative L2 of each weight)
CFLOW_LOOP_TOL = 1e-5
# cflow_cases: the card against the CPU (relative L2)
CFLOW_CASE_TOL = 1e-5
CFLOW_WHILE_MAX = 64


def cflow_lm():
    return tests_module("test_torch_foreach_lm_net")


def cflow_module(lm, make, weights, ctx, batch=CFLOW_BATCH):
    return lm.lm_module(mx, make(mx, **CFLOW_LM), CFLOW_LM["vocab"],
                        CFLOW_LM["width"], CFLOW_LM["layers"], CFLOW_BPTT,
                        batch, weights, ctx, lr=CFLOW_LR)


def cflow_batches(lm, n, ctx, batch=CFLOW_BATCH, seed=0):
    return [lm.lm_data_batch(mx, x, y, CFLOW_LM["width"], CFLOW_LM["layers"],
                             ctx)
            for x, y in lm.lm_batches(CFLOW_LM["vocab"], CFLOW_BPTT, batch,
                                      n, seed)]


def module_step(mod, batch):
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()


def cflow_rnn_check(lm, weights):
    """One step of the foreach graph and of the fused RNN op's graph
    from the same weights on the card: the loss, every gradient and
    every updated weight (relative L2)."""
    gpu = mx.gpu(0)
    batch = cflow_batches(lm, 1, gpu, seed=7)[0]
    y = batch.label[0].asnumpy()
    res = []
    for make in (lm.foreach_lm, lm.fused_lm):
        mod = cflow_module(lm, make, weights, gpu)
        mod.forward(batch, is_train=True)
        mod.backward()
        ex = mod._exec_group.execs[0]
        grads = {k: ex.grad_dict[k].asnumpy() for k in weights}
        loss = lm.cross_entropy(mod.get_outputs()[0].asnumpy(), y)
        mod.update()
        res.append((loss, grads, {k: v.asnumpy() for k, v in
                                  mod.get_params()[0].items()}))
        del mod, ex
        free_card()
    (fl, fg, fw), (rl, rg, rw) = res
    keys = sorted(weights)
    flat = lambda d: np.concatenate([d[k].ravel() for k in keys])  # noqa
    return {"loss": abs(fl - rl) / abs(rl),
            "grads": max(op_rel_l2(fg[k], rg[k]) for k in keys),
            "weights": op_rel_l2(flat(fw), flat(rw)),
            "worst_weight": max(op_rel_l2(fw[k], rw[k]) for k in keys)}, \
        (fl, rl)


def cflow_row(lm, weights):
    """The foreach LM through Module per step (CFLOW_WARM warm and
    CFLOW_STEPS timed steps), then through FusedTrainLoop (K a call,
    one warm call that captures, CFLOW_CALLS timed calls)."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    gpu = mx.gpu(0)
    tokens = CFLOW_BPTT * CFLOW_BATCH
    n = CFLOW_WARM + CFLOW_STEPS
    batches = cflow_batches(lm, n, gpu)
    t0 = time.monotonic()
    mod = cflow_module(lm, lm.foreach_lm, weights, gpu)
    setup_s = time.monotonic() - t0
    zero_launches()
    losses = []
    t0 = time.monotonic()
    for b in batches[:CFLOW_WARM]:
        module_step(mod, b)
    losses.append(lm.cross_entropy(mod.get_outputs()[0].asnumpy(),
                                   batches[0].label[0].asnumpy()))
    first_s = time.monotonic() - t0
    t1 = time.perf_counter()
    for b in batches[CFLOW_WARM:]:
        module_step(mod, b)
    out = mod.get_outputs()[0].asnumpy()
    wall = time.perf_counter() - t1
    losses.append(lm.cross_entropy(out, batches[-1].label[0].asnumpy()))
    ms = wall / CFLOW_STEPS * 1e3
    launches = read_launches()
    spans = device_spans(lambda: module_step(mod, batches[0]))
    if not spans:
        fail("cflow: the profiler saw no device time in a step")
    busy, window, heads = profile_summary(spans, top=6)
    peak = torch.cuda.max_memory_allocated()
    del mod
    free_card()
    # the same graph captured: K steps a call
    fused = cflow_module(lm, lm.foreach_lm, weights, gpu)
    loop = mx.FusedTrainLoop(fused, steps_per_program=CFLOW_K,
                             collect_outputs=False)
    stack = batches[:CFLOW_K]
    t0 = time.monotonic()
    loop.run(stack)
    torch.cuda.synchronize()
    capture_s = time.monotonic() - t0
    t1 = time.perf_counter()
    for _ in range(CFLOW_CALLS):
        loop.run(stack)
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t1
    fms = fwall / (CFLOW_CALLS * CFLOW_K) * 1e3
    fspans = device_spans(lambda: loop.run(stack))
    fbusy, fwindow, fheads = profile_summary(fspans, top=6)
    fpeak = torch.cuda.max_memory_allocated()
    flaunches = read_launches()
    weights_after = {k: v.asnumpy() for k, v in fused.get_params()[0].items()}
    if not all(np.isfinite(v).all() for v in weights_after.values()):
        fail("cflow: the captured loop's weights are not finite")
    del loop, fused
    free_card()
    log("[cflow] %s: cflow_foreach_lm (the word LM written with "
        "sym.contrib.foreach over %d steps: vocabulary %d, %d LSTM layers "
        "of %d from FullyConnected gates, tied decoder, batch %d, SGD lr %g "
        "on the mean loss, fp32 with TF32 off) through Module: %d timed "
        "steps after %d warm (%.1f s with the bind's %.1f): %.3f ms a step, "
        "%.0f tokens/s (host clock, synchronised by value); one profiled "
        "step: device busy %.3f ms, idle share %.3f, %d device "
        "operations; peak %.1f MB; losses %.4f -> %.4f; most device time: "
        "%s" % (card(), CFLOW_BPTT, CFLOW_LM["vocab"], CFLOW_LM["layers"],
                CFLOW_LM["width"], CFLOW_BATCH, CFLOW_LR, CFLOW_STEPS,
                CFLOW_WARM, first_s, setup_s, ms, tokens / ms * 1e3, busy,
                1 - busy / window, len(spans), peak / 1e6, losses[0],
                losses[1], "; ".join("%s %.3f ms" % (nm[:60], t / 1e3)
                                     for nm, t in heads)))
    log("[cflow] %s: cflow_foreach_lm through FusedTrainLoop (K = %d steps "
        "a call, one CUDA graph replayed; the first call captured it in "
        "%.1f s): %d timed calls, %.3f ms a step, %.0f tokens/s; one "
        "profiled call: device busy %.3f ms a step, idle share %.3f, %d "
        "device operations a step; peak %.1f MB; most device time: %s"
        % (card(), CFLOW_K, capture_s, CFLOW_CALLS, fms,
           tokens / fms * 1e3, fbusy / CFLOW_K, 1 - fbusy / fwindow,
           len(fspans) // CFLOW_K, fpeak / 1e6,
           "; ".join("%s %.3f ms" % (nm[:60], t / 1e3) for nm, t in fheads)))
    if not all(np.isfinite(losses)):
        fail("cflow: a loss is not finite: %s" % losses)
    for what, l in (("per step", launches), ("fused", flaunches)):
        if any(l.values()):
            fail("cflow: a flash-attention kernel launched %s: %s"
                 % (what, l))
    return dict(ms=ms, tokens_per_sec=tokens / ms * 1e3, busy_ms=busy,
                idle=1 - busy / window, ops=len(spans), peak_mb=peak / 1e6,
                fused_ms=fms, fused_tokens_per_sec=tokens / fms * 1e3,
                fused_busy_ms=fbusy / CFLOW_K,
                fused_idle=1 - fbusy / fwindow,
                fused_ops=len(fspans) // CFLOW_K, fused_peak_mb=fpeak / 1e6,
                capture_s=capture_s, losses=losses, launches=launches,
                fused_launches=flaunches)


def cflow_loop_check(lm, weights):
    """The captured loop's weights after K steps against K per-step
    Module steps from the same weights (relative L2, the worst weight)."""
    gpu = mx.gpu(0)
    stack = cflow_batches(lm, CFLOW_K, gpu, seed=3)
    per = cflow_module(lm, lm.foreach_lm, weights, gpu)
    for b in stack:
        module_step(per, b)
    want = {k: v.asnumpy() for k, v in per.get_params()[0].items()}
    del per
    free_card()
    fused = cflow_module(lm, lm.foreach_lm, weights, gpu)
    mx.FusedTrainLoop(fused, steps_per_program=CFLOW_K).run(stack)
    got = {k: v.asnumpy() for k, v in fused.get_params()[0].items()}
    del fused
    free_card()
    return max(op_rel_l2(got[k], want[k]) for k in want)


def _cflow_graphs(s):
    """The cases' graphs (symbol module ``s``): a while loop whose trip
    count depends on the data, a cond, a BatchNorm inside foreach."""
    c = mx.sym.contrib
    outs, fin = c.while_loop(
        lambda i, a: s.sum(i) < s.sum(s.var("bound")),
        lambda i, a: ([i * a, s.tanh(a)], [i * 2, a + 1]),
        [s.var("i"), s.var("a")], max_iterations=CFLOW_WHILE_MAX)
    a, b = s.var("ca"), s.var("cb")
    cnd = c.cond(s.var("p"), lambda: a * a, lambda: s.tanh(b) + 1)

    def body(xt, st):
        return s.BatchNorm(data=xt, name="cbn", fix_gamma=False), st + 1

    fe, _ = c.foreach(body, s.var("x"), s.var("st"))
    return s.Group(outs + fin), cnd, fe


def cflow_cases():
    """Each control-flow case on the card against the CPU; returns the
    largest relative L2 and the count of checks."""
    s = mx.sym
    loop, cnd, fe = _cflow_graphs(s)
    rng = np.random.RandomState(11)
    errs = {}

    a0 = rng.uniform(-1, 1, 64).astype(np.float32)

    def while_run(ctx):
        ex = loop.simple_bind(ctx=ctx, grad_req="null", i=(1,), a=(64,),
                              bound=(1,))
        return [o.asnumpy() for o in ex.forward(
            i=np.ones(1, np.float32), a=a0, bound=np.array(
                [3000.0], np.float32))]

    card_w, cpu_w = while_run(mx.gpu(0)), while_run(mx.cpu())
    trips = int((np.abs(cpu_w[0]).sum(axis=1) > 0).sum())
    if not (card_w[0].shape == (CFLOW_WHILE_MAX, 64) and 10 <= trips < 64
            and float(cpu_w[2][0]) == 2.0 ** trips):
        fail("cflow: while_loop ran %d iterations (i %s)"
             % (trips, cpu_w[2]))
    errs["while_loop"] = max(op_rel_l2(g, w) for g, w in zip(card_w, cpu_w))

    def cond_run(ctx, p):
        ex = cnd.simple_bind(ctx=ctx, grad_req={"ca": "write", "cb": "write",
                                                "p": "null"},
                             p=(1,), ca=(5,), cb=(5,))
        ex.forward(is_train=True, p=np.full(1, p, np.float32), ca=ca, cb=cb)
        ex.backward()
        return [ex.outputs[0].asnumpy(), ex.grad_dict["ca"].asnumpy(),
                ex.grad_dict["cb"].asnumpy()]

    ca = rng.uniform(-1, 1, 5).astype(np.float32)
    cb = rng.uniform(-1, 1, 5).astype(np.float32)
    for p in (1.0, 0.0):
        got, want = cond_run(mx.gpu(0), p), cond_run(mx.cpu(), p)
        if not np.array_equal(got[2 if p else 1], np.zeros(5, np.float32)):
            fail("cflow: cond's branch not taken has a gradient on the card")
        errs["cond_%d" % p] = max(op_rel_l2(g, w) for g, w in zip(got, want))

    xv = (rng.randn(6, 4, 3) * 3 + 5).astype(np.float32)

    def bn_run(ctx):
        ex = fe.simple_bind(ctx=ctx, grad_req="null", x=(6, 4, 3), st=(1,))
        ex.forward(is_train=True, x=xv, st=np.zeros(1, np.float32))
        return [ex.outputs[0].asnumpy()] + [
            ex.aux_dict[k].asnumpy() for k in ("cbn_moving_mean",
                                                "cbn_moving_var")]

    got, want = bn_run(mx.gpu(0)), bn_run(mx.cpu())
    if np.allclose(got[1], 0) or np.allclose(got[2], 1):
        fail("cflow: the BatchNorm inside foreach left its moving stats")
    errs["foreach_batchnorm"] = max(op_rel_l2(g, w)
                                    for g, w in zip(got, want))
    errs.update(cflow_block_cases(rng))
    raised = None
    try:
        i, acc, w = s.var("i"), s.var("acc"), s.var("w")
        _, fin = mx.sym.contrib.while_loop(
            lambda i, a: i < 5, lambda i, a: (i * w, [i + 1, a + i * w]),
            [i, acc], max_iterations=8)
        ex = s.sum(fin[1]).simple_bind(
            ctx=mx.gpu(0), i=(1,), acc=(1,), w=(1,),
            grad_req={"w": "write", "i": "null", "acc": "null"})
        ex.forward(is_train=True, i=np.zeros(1, np.float32),
                   acc=np.zeros(1, np.float32), w=np.ones(1, np.float32))
    except mx.base.MXNetError as e:
        raised = str(e)
    if raised is None or "no gradient" not in raised:
        fail("cflow: a symbolic while_loop backward did not raise: %r"
             % raised)
    errs["capture"] = cflow_capture_case()
    errs["capture_singular"] = cflow_singular_case()
    return errs


def cflow_block_cases(rng):
    """A HybridBlock calling F.contrib.foreach (an Elman RNN), on the
    card hybridized and not, against the CPU: output and gradients."""
    from mxtpu_torch.gluon.parameter import load_numpy

    class ForeachRNN(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.i2h = mx.gluon.nn.Dense(16, in_units=8, flatten=False)
                self.h2h = mx.gluon.nn.Dense(16, in_units=16, flatten=False)

        def hybrid_forward(self, F, x, h0):
            def step(xt, h):
                hn = F.tanh(self.i2h(xt) + self.h2h(h))
                return hn, hn
            return F.contrib.foreach(step, x, h0)[0]

    x = rng.randn(12, 4, 8).astype(np.float32)
    head = rng.randn(12, 4, 16).astype(np.float32)
    weights = None
    results = {}
    for where, ctx, hybridize in (("cpu", mx.cpu(), False),
                                  ("card", mx.gpu(0), False),
                                  ("card", mx.gpu(0), True)):
        with mx.sym.NameManager():
            net = ForeachRNN(prefix="frnn_")
        net.initialize(ctx=ctx)
        if weights is None:
            weights = {k: rng.normal(0, 0.3, p.shape).astype(np.float32)
                       for k, p in net.collect_params().items()}
        load_numpy(net.collect_params(), weights)
        if hybridize:
            net.hybridize()
        with mx.autograd.record():
            out = net(mx.nd.array(x, ctx=ctx),
                      mx.nd.zeros((4, 16), ctx=ctx))
        out.backward(mx.nd.array(head, ctx=ctx))
        results[(where, hybridize)] = [out.asnumpy()] + [
            p.grad().asnumpy() for _, p in sorted(
                net.collect_params().items())]
    want = results[("cpu", False)]
    return {"block_%s" % ("hybridized" if h else "imperative"):
            max(op_rel_l2(g, w) for g, w in zip(results[("card", h)], want))
            for h in (False, True)}


def cflow_capture_case():
    """A graph with a cond and a while loop (no gradient through it)
    trained K = 4 steps in a captured FusedTrainLoop against 4 per-step
    Module steps on the card: inside the capture, cond selects both
    branches with torch.where and the loop runs its masked steps, as no
    predicate may be read there.  Returns the worst weight's relative L2
    (CFLOW_CASE_TOL)."""
    s = mx.sym

    def fc(name):
        # a branch's leaves become the cond's free variables, whose
        # shapes only the branch's own declared shapes solve
        return s.FullyConnected(s.var("data"),
                                weight=s.var(name + "_weight", shape=(8, 6)),
                                bias=s.var(name + "_bias", shape=(8,)),
                                num_hidden=8, name=name)

    picked = mx.sym.contrib.cond(s.var("p"), lambda: fc("cfc") * 2,
                                 lambda: s.tanh(fc("cfc2")))
    _, fin = mx.sym.contrib.while_loop(
        lambda i: s.sum(i) < s.sum(s.var("bound")), lambda i: (i, [i * 2]),
        [s.var("i0")], max_iterations=16)
    net = s.MakeLoss(s.mean(s.square(picked)) * s.sum(fin[0]) / 100)
    rng = np.random.RandomState(5)
    w0 = {"%s_%s" % (n, k): rng.normal(0, 0.3, shape).astype(np.float32)
          for n in ("cfc", "cfc2") for k, shape in (("weight", (8, 6)),
                                                    ("bias", (8,)))}
    feed = [(rng.randn(4, 6).astype(np.float32), float(k % 2), float(k + 1),
             float(20 * (k + 1))) for k in range(4)]
    gpu = mx.gpu(0)

    def module():
        mod = mx.mod.Module(net, data_names=("data", "p", "i0", "bound"),
                            label_names=None, context=gpu)
        mod.bind(data_shapes=[("data", (4, 6)), ("p", (1,)), ("i0", (1,)),
                              ("bound", (1,))])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=gpu)
                                    for k, v in w0.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        return mod

    batches = [mx.io.DataBatch(data=[mx.nd.array(d, ctx=gpu)] + [
        mx.nd.array(np.array([v], np.float32), ctx=gpu) for v in rest],
        label=None) for d, *rest in feed]
    per = module()
    for b in batches:
        module_step(per, b)
    fused = module()
    loop = mx.FusedTrainLoop(fused, steps_per_program=4)
    loop.run(batches)
    if loop.captures != (gpu.torch_device.type == "cuda"):
        fail("cflow: the control-flow graph was captured %d times"
             % loop.captures)
    want, got = per.get_params()[0], fused.get_params()[0]
    return max(op_rel_l2(got[k].asnumpy(), want[k].asnumpy()) for k in w0)


def cflow_singular_case():
    """ROADMAP's C9 on the card: a cond whose branch not taken has an
    infinite or NaN derivative (the square root and the log of its own
    affine map's outputs, some negative and one row exactly 0), its
    predicate 1 at every step, trained K = 4 steps (SGD lr 0.1) in a captured
    FusedTrainLoop, where both branches run, and as 4 per-step Module
    steps on the card and on the CPU, where only the branch taken runs.
    Fails unless every weight stays finite; returns the worst relative L2
    of the captured loop's weights and of the card's per-step weights
    against the CPU's (CFLOW_CASE_TOL)."""
    s = mx.sym

    def fc(name):
        return s.FullyConnected(
            s.var("data"), weight=s.var(name + "_weight", shape=(8, 6)),
            bias=s.var(name + "_bias", shape=(8,)), num_hidden=8, name=name)

    def singular():
        z = fc("sfc2")
        return s.sqrt(z) + s.log(z)

    picked = mx.sym.contrib.cond(s.var("p"), lambda: fc("sfc") * 2,
                                 singular)
    net = s.MakeLoss(s.mean(s.square(picked)))
    rng = np.random.RandomState(6)
    w0 = {"%s_%s" % (n, k): (rng.normal(0, 0.5, shape) if k == "weight"
                             else np.zeros(shape)).astype(np.float32)
          for n in ("sfc", "sfc2") for k, shape in (("weight", (8, 6)),
                                                    ("bias", (8,)))}
    feed = []
    for _ in range(4):
        d = rng.randn(4, 6).astype(np.float32)
        d[0] = 0.0                      # z = 0 in that row: log'(0) = inf
        feed.append(d)

    def module(ctx):
        mod = mx.mod.Module(net, data_names=("data", "p"), label_names=None,
                            context=ctx)
        mod.bind(data_shapes=[("data", (4, 6)), ("p", (1,))])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                    for k, v in w0.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        return mod

    def batches(ctx):
        return [mx.io.DataBatch(data=[mx.nd.array(d, ctx=ctx), mx.nd.array(
            np.ones(1, np.float32), ctx=ctx)], label=None) for d in feed]

    weights = {}
    for where, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
        mod = module(ctx)
        for b in batches(ctx):
            module_step(mod, b)
        weights[where] = {k: v.asnumpy() for k, v in
                          mod.get_params()[0].items()}
    fused = module(mx.gpu(0))
    loop = mx.FusedTrainLoop(fused, steps_per_program=4)
    loop.run(batches(mx.gpu(0)))
    if loop.captures != (mx.gpu(0).torch_device.type == "cuda"):
        fail("cflow: the singular cond graph was captured %d times"
             % loop.captures)
    weights["captured"] = {k: v.asnumpy() for k, v in
                           fused.get_params()[0].items()}
    for where, ws in weights.items():
        if not all(np.isfinite(v).all() for v in ws.values()):
            fail("cflow: the singular cond's weights are not finite on the "
                 "%s path: %s" % (where, ws))
    return max(op_rel_l2(weights[where][k], weights["cpu"][k])
               for where in ("captured", "card") for k in w0)


def phase_cflow():
    """The foreach word LM at word_lm's widths, per step and captured,
    its checks against the fused RNN op and the per-step loop, and the
    control-flow cases on the card against the CPU; returns the rows."""
    t0 = time.monotonic()
    lm = cflow_lm()
    weights = lm.lm_weights(CFLOW_LM["vocab"], CFLOW_LM["width"],
                            CFLOW_LM["layers"])
    zero_launches()
    row = cflow_row(lm, weights)
    zero_launches()
    rnn_errs, (fl, rl) = cflow_rnn_check(lm, weights)
    loop_err = cflow_loop_check(lm, weights)
    log("[cflow] %s: one step from the same weights on the card, the "
        "foreach graph against the fused RNN op's (loss %.5f against "
        "%.5f), relative L2 (bounds %s): %s; the captured loop's weights "
        "after %d steps against %d per-step Module steps: worst %.3g "
        "(bound %g)" % (card(), fl, rl, CFLOW_RNN_TOL,
                        ", ".join("%s %.3g" % kv for kv in rnn_errs.items()),
                        CFLOW_K, CFLOW_K, loop_err, CFLOW_LOOP_TOL))
    for k, tol in CFLOW_RNN_TOL.items():
        if not rnn_errs[k] <= tol:
            fail("cflow: the foreach LM's step is %g from the fused RNN "
                 "op's in %s (bound %g)" % (rnn_errs[k], k, tol))
    if not loop_err <= CFLOW_LOOP_TOL:
        fail("cflow: the captured loop is %g from the per-step steps"
             % loop_err)
    row.update(rnn_errs=rnn_errs, loop_err=loop_err)
    zero_launches()
    errs = cflow_cases()
    cases = dict(errs=errs, launches=read_launches())
    log("[cflow] %s: cflow_cases on the card against the CPU, relative L2 "
        "(bound %g): %s; a symbolic while_loop backward raised, as in the "
        "JAX package; flash-attention launches %s; the phase took %.1f s"
        % (card(), CFLOW_CASE_TOL, ", ".join("%s %.3g" % kv
                                             for kv in errs.items()),
           cases["launches"], time.monotonic() - t0))
    bad = {k: v for k, v in errs.items() if not v <= CFLOW_CASE_TOL}
    if bad:
        fail("cflow: cases past their bound: %s" % bad)
    if any(cases["launches"].values()):
        fail("cflow: the cases launched a flash-attention kernel")
    return {"cflow_foreach_lm": row, "cflow_cases": cases}


# ---------------------------------------------------------------------------
# data: CIFAR-10 at its published size through gluon.data into
# ResNet-18 v1
# ---------------------------------------------------------------------------

DATA_SEED = 0
DATA_PER_FILE = 10000             # CIFAR-10's five training files
DATA_BATCH, DATA_WORKERS = 128, 4
DATA_WARM, DATA_ITERS = 5, 60     # the 60 iterations include the warm ones
DATA_PREFETCH_ITERS = 30          # at MXTPU_PREFETCH_DEVICE=2
DATA_LOADER_BATCHES = 100
DATA_ALONE_ITERS = 20             # the step on a batch already on the card
DATA_CHECK_BATCH = 8
DATA_STATE_AT = 5
# one iteration at batch 8 on the card against the CPU from the same
# weights (relative L2 of the losses and of all the parameters, and of
# the moving stats), fp32 with TF32 off: cuDNN's and oneDNN's sums in
# other orders, through BatchNorm at 1x1 in the last stage
DATA_CPU_TOL = 1e-4
DATA_FLIP_DRAWS = 200
# the card's ToTensor and Normalize against the same arithmetic in
# numpy (what process workers run): the largest difference over the
# largest magnitude (about 2.5), a few float32 roundings of the division
# (an H100 80GB HBM3 at 700 W read 7.2e-7 absolute, 2.9e-7 of it)
DATA_TRANSFORM_TOL = 1e-6
DATA_KINDS = (("convolution", ("cudnn", "xmma", "implicit_gemm", "wgrad",
                               "dgrad", "fprop", "nchwToNhwc",
                               "nhwcToNchw")),
              ("image ops and batchify", ("flip", "CatArray", "upsample",
                                          "Memcpy", "memcpy")),
              ("optimizer", ("multi_tensor_apply",)),
              ("reduction", ("reduce_kernel",)),
              ("copy and cast", ("direct_copy", "copy_kernel")),
              ("elementwise", ("elementwise",)))


def cifar_module():
    return tests_module("test_torch_cifar_net")


def data_flops(net, side=32):
    """Flops of one image's training iteration through the convolutions
    and the dense layer of the gluon ``net`` (3 x 2 x their
    multiply-adds: forward and two backward products), from the traced
    graph's shapes at ``side`` x ``side``."""
    with mx.sym.NameManager():
        out, _, _ = net._trace_symbol(mx.sym.var("data0"))
    internals = out.get_internals()
    _, shapes, _ = internals.infer_shape(data0=(1, 3, side, side))
    macs = 0
    for (node, _), shape in zip(internals._outputs, shapes):
        if node.is_variable or shape is None:
            continue
        if node.op.name == "Convolution":
            w_shape = _input_shape(internals, shapes, node, 1)
            macs += int(np.prod(shape)) * int(np.prod(w_shape[1:]))
        elif node.op.name == "FullyConnected":
            w_shape = _input_shape(internals, shapes, node, 1)
            macs += int(np.prod(shape)) * int(w_shape[1])
    return 3 * 2 * macs


def _input_shape(internals, shapes, node, k):
    entry = node.inputs[k]
    return shapes[internals._outputs.index(entry)]


class prefetch_depth(object):
    """MXTPU_PREFETCH_DEVICE set to ``depth`` inside the scope."""

    def __init__(self, depth):
        self.depth = depth

    def __enter__(self):
        self.saved = os.environ.get("MXTPU_PREFETCH_DEVICE")
        os.environ["MXTPU_PREFETCH_DEVICE"] = str(self.depth)

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("MXTPU_PREFETCH_DEVICE", None)
        else:
            os.environ["MXTPU_PREFETCH_DEVICE"] = self.saved


def data_train(cifar, net, step, loss_fn, iters, seed, warm=0):
    """``iters`` iterations over the loader (threads, the flip on);
    returns (ms an iteration after ``warm``, the input-wait share of
    that wall time, the mean losses)."""
    gpu_losses = []
    it = iter(cifar.loader(mx, DATA_ROOT[0], DATA_BATCH, DATA_WORKERS, seed))
    for _ in range(warm):
        x, y = next(it)
        gpu_losses.append(cifar.iteration(mx, net, step, loss_fn, x,
                                          y).mean())
    if gpu_losses:
        float(gpu_losses[-1].asnumpy())
    telemetry.clear()
    t0 = time.perf_counter()
    for _ in range(iters - warm):
        x, y = next(it)
        gpu_losses.append(cifar.iteration(mx, net, step, loss_fn, x,
                                          y).mean())
    float(gpu_losses[-1].asnumpy())
    wall = time.perf_counter() - t0
    waits = telemetry.metrics()
    del it
    losses = [float(l.asnumpy()) for l in gpu_losses]
    return (wall / (iters - warm) * 1e3, waits["input_wait_sum_s"] / wall,
            losses)


def loader_rate(make, batches):
    """Images a second of the loader alone over ``batches`` batches,
    each batch's arrays waited for on the card."""
    it = iter(make())
    next(it)  # the workers' start
    t0 = time.perf_counter()
    for _ in range(batches):
        b = next(it)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del it
    return batches * DATA_BATCH / wall


def data_row(cifar):
    """ResNet-18 v1 on CIFAR-10 through DataLoader: DATA_ITERS
    iterations (DATA_WARM warm) at MXTPU_PREFETCH_DEVICE 0, then
    DATA_PREFETCH_ITERS at 2; a profiled iteration; the loader alone."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    gpu = mx.gpu(0)
    mx.random.seed(DATA_SEED)
    net = cifar.resnet18(mx, gpu)
    step = cifar.trainer(mx, net)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    zero_launches()
    with prefetch_depth(0):
        ms, wait0, losses = data_train(cifar, net, step, loss_fn,
                                       DATA_ITERS, DATA_SEED, DATA_WARM)
    log("[data] %d iterations at MXTPU_PREFETCH_DEVICE 0 done" % DATA_ITERS)
    with prefetch_depth(2):
        ms2, wait2, losses2 = data_train(cifar, net, step, loss_fn,
                                         DATA_PREFETCH_ITERS, DATA_SEED + 1,
                                         DATA_WARM)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    x, y = next(iter(cifar.loader(mx, DATA_ROOT[0], DATA_BATCH, 0,
                                  DATA_SEED)))
    # the same iterations on one batch already on the card: the step
    # without the loader's threads beside it
    cifar.iteration(mx, net, step, loss_fn, x, y).asnumpy()
    t0 = time.perf_counter()
    for _ in range(DATA_ALONE_ITERS):
        last = cifar.iteration(mx, net, step, loss_fn, x, y)
    last.asnumpy()
    alone_ms = (time.perf_counter() - t0) / DATA_ALONE_ITERS * 1e3
    spans = device_spans(lambda: cifar.iteration(mx, net, step, loss_fn, x,
                                                 y))
    if not spans:
        fail("data: the profiler saw no device time in an iteration")
    busy, window, heads = profile_summary(spans, top=6)
    kinds = sorted(by_kind(spans, DATA_KINDS).items(), key=lambda kv: -kv[1])
    # the same iteration with its input made on the card: the loader's
    # share of a profiled iteration
    lspans = device_spans(lambda: cifar.iteration(
        mx, net, step, loss_fn, *next(iter(cifar.loader(
            mx, DATA_ROOT[0], DATA_BATCH, 0, DATA_SEED + 2)))))
    lbusy, lwindow, _ = profile_summary(lspans, top=1)
    flops = data_flops(net) * DATA_BATCH
    bound, bound_by = bound_ms(0, flops, torch.float32)
    rates = {}
    for name, make in (
            ("0 workers", lambda: cifar.loader(mx, DATA_ROOT[0], DATA_BATCH,
                                               0, DATA_SEED)),
            ("4 threads", lambda: cifar.loader(mx, DATA_ROOT[0], DATA_BATCH,
                                               DATA_WORKERS, DATA_SEED)),
            ("4 processes (numpy)", lambda: mx.gluon.data.DataLoader(
                cifar.numpy_dataset(mx, DATA_ROOT[0]),
                batch_size=DATA_BATCH, shuffle=True, last_batch="discard",
                num_workers=DATA_WORKERS, thread_pool=False,
                seed=DATA_SEED))):
        rates[name] = loader_rate(make, DATA_LOADER_BATCHES)
        log("[data] the loader alone at %s: %.1f images/s"
            % (name, rates[name]))
    log("[data] %s: data_cifar_resnet18 (CIFAR-10's five training batches "
        "written by the phase, %d images, through CIFAR10, "
        "transform_first(RandomFlipLeftRight, ToTensor, Normalize), "
        "DataLoader batch %d, shuffle, last_batch discard, %d thread "
        "workers; resnet18_v1(classes=10) hybridized, Trainer SGD lr %g "
        "momentum %g wd %g, fp32 with TF32 off): %d timed iterations after "
        "%d warm at MXTPU_PREFETCH_DEVICE 0: %.3f ms an iteration, %.1f "
        "images/s, input-wait share %.3f (telemetry.input_wait); %d at "
        "MXTPU_PREFETCH_DEVICE 2: %.3f ms, %.1f images/s, input-wait share "
        "%.3f; mean losses %.4f -> %.4f"
        % (card(), 5 * DATA_PER_FILE, DATA_BATCH, DATA_WORKERS,
           cifar.OPT["learning_rate"],
           cifar.OPT["momentum"], cifar.OPT["wd"], DATA_ITERS - DATA_WARM,
           DATA_WARM, ms, DATA_BATCH / ms * 1e3, wait0,
           DATA_PREFETCH_ITERS - DATA_WARM, ms2, DATA_BATCH / ms2 * 1e3,
           wait2, losses[0], losses[-1]))
    log("[data] %s: data_cifar_resnet18's step on one batch already on "
        "the card, no loader running: %.3f ms an iteration over %d "
        "(%.1f images/s); the loader's threads make the step %.2fx that"
        % (card(), alone_ms, DATA_ALONE_ITERS, DATA_BATCH / alone_ms * 1e3,
           ms / alone_ms))
    log("[data] %s: data_cifar_resnet18, one profiled iteration on a "
        "batch already on the card: device busy %.3f ms, idle share %.3f, "
        "%d device operations, by kind: %s; most device time: %s; with "
        "its batch made by the loader inside the profile: busy %.3f ms, "
        "idle share %.3f, %d operations; peak %.1f MB allocated; the "
        "bound: %.1f GFLOP an iteration (data_flops) at 67 TFLOP/s: %.3f "
        "ms (%s), busy is %.2fx it"
        % (card(), busy, 1 - busy / window, len(spans),
           "; ".join("%s %.3f ms" % (k, t / 1e3) for k, t in kinds),
           "; ".join("%s %.3f ms" % (n[:60], t / 1e3) for n, t in heads),
           lbusy, 1 - lbusy / lwindow, len(lspans), peak / 1e6,
           flops / 1e9, bound, bound_by, busy / bound))
    log("[data] %s: the loader alone, %d batches of %d: %s images/s"
        % (card(), DATA_LOADER_BATCHES, DATA_BATCH,
           ", ".join("%s %.1f" % kv for kv in rates.items())))
    if not np.isfinite(losses + losses2).all():
        fail("data: a loss is not finite")
    if any(launches.values()):
        fail("data: a flash-attention kernel launched: %s" % launches)
    join_loader_threads()
    result = dict(ms=ms, imgs_per_sec=DATA_BATCH / ms * 1e3,
                  input_wait=wait0, prefetch_ms=ms2,
                  prefetch_imgs_per_sec=DATA_BATCH / ms2 * 1e3,
                  prefetch_input_wait=wait2, alone_ms=alone_ms, busy_ms=busy,
                  idle=1 - busy / window, ops=len(spans),
                  loader_busy_ms=lbusy, peak_mb=peak / 1e6,
                  bound_ms=bound, loader_imgs_per_sec=rates,
                  losses=[losses[0], losses[-1]], launches=launches)
    del net, step
    free_card()
    return result


LOADER_THREADS = ("mxtpu-dataloader", "mxtpu-device-prefetch")


def join_loader_threads(timeout=30):
    """Every DataLoader thread ended: none may outlive the phase (a
    thread inside a CUDA call when the interpreter exits aborts it)."""
    for t in threading.enumerate():
        if t.name in LOADER_THREADS:
            t.join(timeout)
            if t.is_alive():
                fail("data: a loader thread (%s) did not end" % t.name)


def _host_batches(batches):
    return [[np.asarray(b.asnumpy()) for b in batch] for batch in batches]


def data_checks(cifar):
    """The worker modes' batches, state()/set_state re-entry, the flip's
    rate, and one batch-8 iteration against the CPU; returns the
    readings."""
    from mxtpu_torch.gluon.parameter import load_numpy

    root = DATA_ROOT[0]

    def first(loader, n=3):
        out = []
        for batch in loader:
            out.append(batch)
            if len(out) == n:
                break
        return _host_batches(out)

    def numpy_loader(workers, thread_pool=True):
        return mx.gluon.data.DataLoader(
            cifar.numpy_dataset(mx, root), batch_size=DATA_BATCH,
            shuffle=True, last_batch="discard", num_workers=workers,
            thread_pool=thread_pool, seed=DATA_SEED)

    # the worker modes over one dataset: bitwise equal batches
    card = {"0 workers": first(cifar.loader(mx, root, DATA_BATCH, 0,
                                            DATA_SEED, flip=False)),
            "4 threads": first(cifar.loader(mx, root, DATA_BATCH,
                                            DATA_WORKERS, DATA_SEED,
                                            flip=False))}
    host = {"0 workers": first(numpy_loader(0)),
            "4 threads": first(numpy_loader(DATA_WORKERS)),
            "4 processes": first(numpy_loader(DATA_WORKERS, False))}
    for modes in (card, host):
        want = modes["0 workers"]
        for name, got in modes.items():
            if not all(np.array_equal(g, w) for gb, wb in zip(got, want)
                       for g, w in zip(gb, wb)):
                fail("data: the loader's batches at %s differ from 0 "
                     "workers'" % name)
    # the image ops on the card against the same transform in numpy: a
    # float32 rounding of the division apart
    ulp = max(float(np.abs(g - w).max() / np.abs(w).max())
              for gb, wb in zip(card["0 workers"], host["0 workers"])
              for g, w in zip(gb, wb))
    if not ulp <= DATA_TRANSFORM_TOL:
        fail("data: the card's transform is %g from numpy's (bound %g)"
             % (ulp, DATA_TRANSFORM_TOL))
    whole = cifar.loader(mx, root, DATA_BATCH, DATA_WORKERS, DATA_SEED,
                         flip=False)
    seen = []
    for i, batch in enumerate(whole):
        seen.append(batch)
        if i == DATA_STATE_AT - 1:
            state = whole.state()
        if i == DATA_STATE_AT + 2:
            break
    fresh = cifar.loader(mx, root, DATA_BATCH, DATA_WORKERS, DATA_SEED,
                         flip=False)
    fresh.set_state(state)
    resumed = first(fresh)
    if not all(np.array_equal(g, w) for gb, wb in zip(
            resumed, _host_batches(seen[DATA_STATE_AT:])) for g, w in
            zip(gb, wb)):
        fail("data: set_state(%s) did not re-enter batches %d-%d"
             % (state, DATA_STATE_AT + 1, DATA_STATE_AT + 3))
    img = mx.nd.array(np.arange(32 * 32 * 3, dtype=np.float32).reshape(
        32, 32, 3), ctx=mx.gpu(0))
    flipped = np.flip(img.asnumpy(), 1)
    n = sum(np.array_equal(mx.nd._image_random_flip_left_right(
        img).asnumpy(), flipped) for _ in range(DATA_FLIP_DRAWS))
    half = DATA_FLIP_DRAWS / 2
    if not abs(n - half) < 5 * np.sqrt(DATA_FLIP_DRAWS * 0.25):
        fail("data: the flip flipped %d of %d draws" % (n, DATA_FLIP_DRAWS))
    # one iteration at batch 8 on the card and on the CPU
    x, y = _host_batches([next(iter(cifar.loader(
        mx, root, DATA_CHECK_BATCH, 0, DATA_SEED + 5, flip=False)))])[0]
    res, weights = [], None
    for ctx in (mx.gpu(0), mx.cpu()):
        net = cifar.resnet18(mx, ctx)
        with mx.autograd.pause():
            net(mx.nd.array(x, ctx=ctx))
        if weights is None:
            weights = {k: p.data().asnumpy()
                       for k, p in net.collect_params().items()}
        else:
            load_numpy(net.collect_params(), weights)
        step = cifar.trainer(mx, net)
        loss = cifar.iteration(mx, net, step,
                               mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               mx.nd.array(x, ctx=ctx),
                               mx.nd.array(y, ctx=ctx, dtype=y.dtype))
        res.append((loss.asnumpy(), {k: p.data().asnumpy() for k, p in
                                     net.collect_params().items()}))
        del net, step
    (gl, gp), (cl, cp) = res
    params = sorted(k for k in gp if "running" not in k)
    stats = sorted(k for k in gp if "running" in k)
    flat = lambda d, ks: np.concatenate([d[k].ravel() for k in ks])  # noqa
    cpu_errs = {"losses": op_rel_l2(gl, cl),
                "parameters": op_rel_l2(flat(gp, params), flat(cp, params)),
                "moving stats": op_rel_l2(flat(gp, stats), flat(cp, stats))}
    if not max(cpu_errs.values()) <= DATA_CPU_TOL:
        fail("data: the batch-%d iteration is %s from the CPU's (bound %g)"
             % (DATA_CHECK_BATCH, cpu_errs, DATA_CPU_TOL))
    free_card()
    join_loader_threads()
    return dict(flips=int(n), cpu_errs=cpu_errs, state=state,
                transform_err=ulp)


DATA_ROOT = []


def phase_data():
    """CIFAR-10 at its published size through gluon.data into ResNet-18
    v1 on the card; returns the row."""
    t0 = time.monotonic()
    cifar = cifar_module()
    tmp = tempfile.mkdtemp(prefix="mxtpu-cifar-")
    atexit.register(shutil.rmtree, tmp, True)
    DATA_ROOT[:] = [tmp]
    nbytes = cifar.write_cifar10(tmp, per_file=DATA_PER_FILE, seed=DATA_SEED)
    write_s = time.monotonic() - t0
    log("[data] %.2f MB of CIFAR-10 written in %.1f s" % (nbytes / 1e6,
                                                        write_s))
    row = data_row(cifar)
    zero_launches()
    checks = data_checks(cifar)
    row.update(checks, check_launches=read_launches())
    log("[data] %s: the worker modes' first three batches equal (0 "
        "workers and 4 threads on the card's image ops; 0 workers, 4 "
        "threads and 4 processes over numpy; the flip left out), the "
        "card's transform %.3g from numpy's (bound %g); "
        "set_state(%s) re-entered batches %d-%d; the flip flipped %d of "
        "%d draws; one iteration at batch %d against the CPU, relative L2 "
        "(bound %g): %s; %.2f MB of CIFAR-10 written in %.1f s; the phase "
        "took %.1f s" % (card(), checks["transform_err"], DATA_TRANSFORM_TOL,
                         checks["state"], DATA_STATE_AT + 1,
                         DATA_STATE_AT + 3, checks["flips"], DATA_FLIP_DRAWS,
                         DATA_CHECK_BATCH, DATA_CPU_TOL,
                         ", ".join("%s %.3g" % kv
                                   for kv in checks["cpu_errs"].items()),
                         nbytes / 1e6, write_s, time.monotonic() - t0))
    if any(row["check_launches"].values()):
        fail("data: the checks launched a flash-attention kernel")
    shutil.rmtree(tmp, True)
    return {"data_cifar_resnet18": row}


# ---------------------------------------------------------------------------
# det: the detection ops: examples/ssd and examples/rcnn, a Faster R-CNN
# VGG16 step at 600 x 1000 and SSD300's heads
# ---------------------------------------------------------------------------

DET_SSD = "ssd/ssd_mini.py"
# its 8 epochs at tests/test_examples.py's threshold: at its default 0.2
# no class score passes in either package, whose MultiBoxTarget does no
# negative mining, so the background class takes every anchor
DET_SSD_ARGS = ("--det-threshold", "0.05")
DET_FRCNN = "rcnn/faster_rcnn_mini.py"  # at its defaults: 6 epochs
DET_FRCNN_GATE = 0.5     # tests/test_examples.py's FINAL_ROI_ACCURACY gate
DET_WARM, DET_STEPS = 2, 6              # the VGG16 row's steps
# the VGG16 step on the card against the CPU: the decoded boxes before
# NMS and the box targets (the decoding's exp rounds apart on the two)
# within DET_BOX_TOL relative to the largest coordinate; each gradient's
# relative L2 within DET_GRAD_TOL (float32 products in other orders);
# the NMS masks, the picks, the pooled features, class ids and scores
# equal
DET_BOX_TOL = 1e-5
DET_GRAD_TOL = 1e-4
DET_TARGET_BATCH = 32                   # MultiBoxTarget, 1-8 boxes an image
DET_DETECT_BATCH = 8                    # MultiBoxDetection, 21 classes
DET_REPEAT = 3                          # timed calls of each head op


class _TimedLines(_Lines):
    """The log's lines and the clock at each."""

    def __init__(self):
        super().__init__()
        self.times = []

    def emit(self, record):
        super().emit(record)
        self.times.append(time.monotonic())


def det_module():
    """tests/test_torch_detection_net.py: Faster R-CNN VGG16 and SSD300's
    heads, written against gluon (imports only numpy)."""
    return tests_module("test_torch_detection_net")


def det_examples():
    """examples/ssd and examples/rcnn at their defaults on the card: the
    SSD's detections per image and seconds an epoch; Faster R-CNN's
    FINAL_ROI_ACCURACY, its proposals, pooled ROIs and parameters all on
    the card."""
    lines, root = _TimedLines(), logging.getLogger()
    root.addHandler(lines)
    t0 = time.monotonic()
    try:
        out, _, secs = example_run(DET_SSD, DET_SSD_ARGS, "det")
    finally:
        root.removeHandler(lines)
    epochs = [t for t, m in zip(lines.times, lines.lines)
              if m.startswith("epoch ")]
    per_epoch = np.diff([t0] + epochs)
    found = [ln for ln in lines.lines if ln.startswith("detections per")]
    if not found or not epochs:
        fail("det: %s printed no epoch or detection line" % DET_SSD)
    dets = json.loads(found[-1].split(":", 1)[1])
    ssd = dict(seconds=secs, epoch_s=per_epoch.tolist(), detections=dets,
               launches=read_launches())
    log("[det] %s: det_ssd_mini (%s, 8 epochs, %s): %.1f s, seconds an "
        "epoch %s (the first with the set-up); detections per image (first "
        "8) %s; flash-attention launches %s"
        % (card(), DET_SSD, " ".join(DET_SSD_ARGS), secs, " ".join(
            "%.2f" % s for s in per_epoch), dets, ssd["launches"]))

    devices = {"rois": set(), "data": set(), "params": set()}
    nd = mx.nd
    pool, prop = nd.ROIPooling, nd.contrib.MultiProposal

    def pool_spy(data, rois, *a, **kw):
        devices["data"].add(str(data.context))
        devices["rois"].add(str(rois.context))
        return pool(data, rois, *a, **kw)

    def prop_spy(*a, **kw):
        out = prop(*a, **kw)
        devices["rois"].add(str(out.context))
        return out

    step = mx.gluon.Trainer.step

    def step_spy(self, *a, **kw):
        devices["params"].update(str(p.data().context) for p in self._params)
        return step(self, *a, **kw)

    zero_launches()
    nd.ROIPooling, nd.contrib.MultiProposal = pool_spy, prop_spy
    mx.gluon.Trainer.step = step_spy
    try:
        out, lines, fsecs = example_run(DET_FRCNN, [], "det")
    finally:
        nd.ROIPooling, nd.contrib.MultiProposal = pool, prop
        mx.gluon.Trainer.step = step
    acc = re.findall(r"^FINAL_ROI_ACCURACY ([0-9.]+)", out, re.M)
    frcnn = dict(seconds=fsecs, accuracy=float(acc[-1]) if acc else None,
                 devices={k: sorted(v) for k, v in devices.items()},
                 launches=read_launches())
    log("[det] %s: det_frcnn_mini (%s at its defaults, 6 epochs, its "
        "mx.cpu() made the card's): %.1f s, FINAL_ROI_ACCURACY %s (gate > "
        "%g); the devices of the proposals, the pooled maps and the "
        "parameters: %s; flash-attention launches %s"
        % (card(), DET_FRCNN, fsecs, frcnn["accuracy"], DET_FRCNN_GATE,
           frcnn["devices"], frcnn["launches"]))
    if frcnn["accuracy"] is None or not frcnn["accuracy"] > DET_FRCNN_GATE:
        fail("det: %s's FINAL_ROI_ACCURACY %s, not above %g"
             % (DET_FRCNN, acc, DET_FRCNN_GATE))
    card_dev = str(mx.gpu(0))
    for what, devs in devices.items():
        if devs != {card_dev}:
            fail("det: %s's %s were on %s, not the card"
                 % (DET_FRCNN, what, sorted(devs)))
    return {"det_ssd_mini": ssd, "det_frcnn_mini": frcnn}


def det_frcnn_net(dn, ctx, weights=None):
    from mxtpu_torch.gluon.parameter import load_numpy

    with mx.sym.NameManager():
        net = dn.FasterRCNN(mx, ctx, dn.VGG16)
    if weights is not None:
        load_numpy(net.params, weights)
    return net


def det_proposal_check(dn, net, x, info):
    """The proposals from the card's RPN outputs, on the card and on the
    CPU: the top-12,000 order and scores equal, the decoded boxes within
    DET_BOX_TOL, the NMS mask of the same boxes equal, the picked rois
    and the pooled features equal.  Returns the readings and the card's
    feature map and rois."""
    from mxtpu_torch.ops import rcnn

    spec = dn.VGG16
    attrs = dn.proposal_attrs(spec)
    feat, _, score, delta = net.rpn(x)
    rois = net.proposals(score, delta, info)
    a = len(dn.RPN_SCALES) * len(dn.RPN_RATIOS)
    anchors = rcnn._generate_anchors(dn.STRIDE, dn.RPN_SCALES, dn.RPN_RATIOS)
    got, want = [rcnn.proposal_boxes(
        score._data[:, a:].to(dev), delta._data.to(dev), info._data.to(dev),
        anchors, dn.STRIDE, spec["pre_nms"], float(attrs["rpn_min_size"]),
        False) for dev in (score._data.device, "cpu")]
    out = {}
    out["order_equal"] = bool(torch.equal(got[2].cpu(), want[2]))
    out["scores_equal"] = bool(torch.equal(got[1].cpu(), want[1]))
    out["box_err"] = float((got[0].cpu() - want[0]).abs().max()
                           / want[0].abs().max())
    sup_card = rcnn._greedy_nms_suppressed(got[0], attrs["threshold"])
    sup_cpu = rcnn._greedy_nms_suppressed(got[0].cpu(), attrs["threshold"])
    sup_own = rcnn._greedy_nms_suppressed(want[0], attrs["threshold"])
    out["mask_equal"] = bool(torch.equal(sup_card.cpu(), sup_cpu))
    out["kept"] = int((~sup_cpu).sum())
    out["own_mask_flips"] = int((sup_own != sup_cpu).sum())
    picked, _ = rcnn.proposal_pick(got[0].cpu(), got[1].cpu(), sup_cpu,
                                   spec["post_nms"])
    want_rois = picked[0, :spec["rois"]].numpy()
    out["rois_equal"] = bool(np.array_equal(rois.asnumpy()[:, 1:],
                                            want_rois))
    pooled = mx.nd.ROIPooling(feat, rois, pooled_size=(7, 7),
                              spatial_scale=1.0 / dn.STRIDE)
    cpu = mx.cpu()
    pooled_cpu = mx.nd.ROIPooling(feat.as_in_context(cpu),
                                  rois.as_in_context(cpu),
                                  pooled_size=(7, 7),
                                  spatial_scale=1.0 / dn.STRIDE)
    out["pooled_equal"] = bool(np.array_equal(pooled.asnumpy(),
                                              pooled_cpu.asnumpy()))
    return out, feat, rois


def det_grad_check(dn, net, x, feat, rois, t):
    """One step's gradients on the card against the CPU from the same
    weights, layer by layer from the loss down (the net module's
    ``staged_grads``): each layer (the loss; a linear part, a ReLU,
    ROIPooling and a pool apart) is given the card's input and the
    card's gradient of its output on both devices.  The inputs are
    shared because a ReLU or a max decides on values that two devices
    round apart: about one pre-activation in 10^6 lies within float32's
    rounding of 0, and one flipped ReLU moves a layer's weight gradient
    by 1e-3 (PERF.md's detection findings).  Returns each parameter's
    and each layer's input gradient's relative L2, and the loss on each
    device."""
    cpu = mx.cpu()
    weights = {k: p.data().asnumpy() for k, p in net.params.items()}
    ref = det_frcnn_net(dn, cpu, weights)
    t_cpu = {k: v.as_in_context(cpu) for k, v in t.items()}
    errs, losses = dn.staged_grads(
        mx, [(net, mx.gpu(0), t), (ref, cpu, t_cpu)], x, feat, rois,
        lambda a, b: op_rel_l2(a.asnumpy(), b.asnumpy()))
    for k in net.params:
        errs[k] = op_rel_l2(net.params[k].grad().asnumpy(),
                            ref.params[k].grad().asnumpy())
    del ref
    return errs, losses


def det_frcnn_vgg16_row(dn):
    """Faster R-CNN VGG16 at 600 x 1000 on the card: DET_WARM + DET_STEPS
    SGD steps through gluon's Trainer (momentum 0.9, wd 5e-4), a profiled
    step, then the proposal and gradient checks against the CPU."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    gpu = mx.gpu(0)
    spec = dn.VGG16
    t0 = time.monotonic()
    net = det_frcnn_net(dn, gpu)
    x_np, info_np = dn.image(spec)
    x, info = mx.nd.array(x_np, ctx=gpu), mx.nd.array(info_np, ctx=gpu)
    t = dn.targets(mx, gpu, spec)
    trainer = mx.gluon.Trainer(net.params, "sgd", {
        "learning_rate": dn.LR, "momentum": 0.9, "wd": 5e-4})
    setup_s = time.monotonic() - t0
    losses = []

    def step():
        out = net.step(x, info, t)
        trainer.step(1)
        losses.append(out["loss"])

    zero_launches()
    t0 = time.monotonic()
    for _ in range(DET_WARM):
        step()
    float(losses[-1].asnumpy())
    first_s = time.monotonic() - t0
    t1 = time.perf_counter()
    for _ in range(DET_STEPS):
        step()
    float(losses[-1].asnumpy())
    ms = (time.perf_counter() - t1) / DET_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    spans = device_spans(step)
    if not spans:
        fail("det: the profiler saw no device time in a VGG16 step")
    busy, window, heads = profile_summary(spans, top=8)
    kinds = sorted(by_kind(spans).items(), key=lambda kv: -kv[1])
    launches = read_launches()
    vals = np.array([float(v.asnumpy()) for v in losses])
    log("[det] %s: det_frcnn_vgg16 (Faster R-CNN, the zoo's VGG16 to "
        "conv5_3, one 600x1000 image, RPN 512 wide over 9 anchors, "
        "MultiProposal 12000 -> NMS 0.7 -> 2000, 128 ROIs pooled 7x7, fc6 "
        "and fc7 4096, 21 classes, SGD lr %g momentum 0.9 wd 5e-4, fp32 "
        "with TF32 off): %d timed steps after %d warm (%.1f s with the "
        "set-up's %.1f): %.3f ms a step (host clock, synchronised by "
        "value); one profiled step: device busy %.3f ms, idle share %.3f, "
        "%d device operations; peak device memory %.1f MB allocated; by "
        "kind: %s; most device time: %s"
        % (card(), dn.LR, DET_STEPS, DET_WARM, first_s, setup_s, ms, busy,
           1 - busy / window, len(spans), peak / 1e6,
           "; ".join("%s %.3f ms" % (k, v / 1e3) for k, v in kinds),
           "; ".join("%s %.3f ms" % (n[:70], v / 1e3) for n, v in heads)))
    log("[det] det_frcnn_vgg16: losses by step %s"
        % " ".join("%.4f" % v for v in vals))
    if not np.isfinite(vals).all():
        fail("det: a VGG16 loss is not finite: %s" % vals.tolist())
    if any(launches.values()):
        fail("det: the VGG16 step launched a flash-attention kernel: %s"
             % launches)
    t0 = time.monotonic()
    prop, feat, rois = det_proposal_check(dn, net, x, info)
    errs, step_losses = det_grad_check(dn, net, x, feat, rois, t)
    worst = max(errs, key=errs.get)
    log("[det] %s: det_frcnn_vgg16 against the CPU (%.1f s): the "
        "12000 boxes before NMS from the card's RPN: order equal %s, "
        "scores equal %s, boxes %.3g of the largest (bound %g); the NMS "
        "mask of the card's boxes on the card and the CPU equal %s (%d "
        "kept; the CPU's own boxes flip %d); the 128 rois equal %s; the "
        "pooled 128x512x7x7 equal %s; one step's gradients (loss %.6f on "
        "the card, %.6f on the CPU), relative L2 (bound %g): worst %.3g in "
        "%s; %s" % (card(), time.monotonic() - t0, prop["order_equal"],
                    prop["scores_equal"], prop["box_err"], DET_BOX_TOL,
                    prop["mask_equal"], prop["kept"],
                    prop["own_mask_flips"], prop["rois_equal"],
                    prop["pooled_equal"], step_losses[0], step_losses[1],
                    DET_GRAD_TOL, errs[worst], worst,
                    ", ".join("%s %.3g" % kv for kv in errs.items())))
    for key in ("order_equal", "scores_equal", "mask_equal", "rois_equal",
                "pooled_equal"):
        if not prop[key]:
            fail("det: the VGG16 proposals on the card and the CPU differ: "
                 "%s is false" % key)
    if not prop["box_err"] <= DET_BOX_TOL:
        fail("det: the decoded boxes are %g apart" % prop["box_err"])
    if not errs[worst] <= DET_GRAD_TOL:
        fail("det: the VGG16 step's gradient of %s is %g from the CPU's"
             % (worst, errs[worst]))
    row = dict(ms=ms, busy_ms=busy, idle=1 - busy / window, ops=len(spans),
               peak_mb=peak / 1e6, launches=launches,
               losses=vals.tolist(), proposals=prop, grad_worst=errs[worst],
               grad_worst_param=worst)
    del net, trainer, losses, feat, rois
    free_card()
    return row


def det_time(fn):
    """Host ms a call of fn with its outputs read back, the best of
    DET_REPEAT after a warm call."""
    def run():
        out = fn()
        for o in (out if isinstance(out, (list, tuple)) else [out]):
            o.asnumpy()

    run()
    best = float("inf")
    for _ in range(DET_REPEAT):
        t0 = time.perf_counter()
        run()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def det_ssd300_heads(dn):
    """SSD300's priors over its six maps (8732 anchors), MultiBoxTarget
    at batch 32 and MultiBoxDetection at batch 8 on the card against the
    CPU.  The detection NMS holds an IoU tile of (batch, 256, 8732), 71.5
    MB of float32 at batch 8, never the 8732^2 matrix (305 MB an image)."""
    from mxtpu_torch.ops import vision

    gpu, cpu = mx.gpu(0), mx.cpu()
    nd = mx.nd
    zero_launches()
    anchors = dn.ssd300_anchors(mx, gpu)
    anchors_cpu = dn.ssd300_anchors(mx, cpu)
    out = {"anchors": anchors.shape[1],
           "anchors_equal": bool(np.array_equal(anchors.asnumpy(),
                                                anchors_cpu.asnumpy()))}
    if anchors.shape != (1, dn.SSD300_ANCHORS, 4) or \
            not out["anchors_equal"]:
        fail("det: SSD300's priors: %s, equal to the CPU's %s"
             % (anchors.shape, out["anchors_equal"]))
    labels = dn.ssd_labels(DET_TARGET_BATCH)
    probs, loc = dn.ssd_predictions(DET_TARGET_BATCH)
    cls_preds = np.log(probs)

    def target(ctx, a):
        return nd.contrib.MultiBoxTarget(a, nd.array(labels, ctx=ctx),
                                         nd.array(cls_preds, ctx=ctx))

    got = [o.asnumpy() for o in target(gpu, anchors)]
    want = [o.asnumpy() for o in target(cpu, anchors_cpu)]
    out["target_box_err"] = float(np.abs(got[0] - want[0]).max()
                                  / max(np.abs(want[0]).max(), 1e-30))
    out["target_mask_equal"] = bool(np.array_equal(got[1], want[1]))
    out["target_cls_equal"] = bool(np.array_equal(got[2], want[2]))
    out["positives"] = int((want[2] > 0).sum())
    out["target_ms"] = det_time(lambda: target(gpu, anchors))
    out["target_cpu_ms"] = det_time(lambda: target(cpu, anchors_cpu))

    b = DET_DETECT_BATCH
    p_t = torch.as_tensor(probs[:b])
    l_t = torch.as_tensor(loc[:b])
    kw = dict(clip=True, threshold=0.01, background_id=0)
    dec_card = vision.detection_boxes(p_t.to(anchors._data.device),
                                      l_t.to(anchors._data.device),
                                      anchors._data, **kw)
    dec_cpu = vision.detection_boxes(p_t, l_t, anchors_cpu._data, **kw)
    out["decode_cls_equal"] = bool(torch.equal(dec_card[0].cpu(),
                                               dec_cpu[0]))
    out["decode_score_equal"] = bool(torch.equal(dec_card[1].cpu(),
                                                 dec_cpu[1]))
    out["decode_box_err"] = float((dec_card[2].cpu() - dec_cpu[2]).abs()
                                  .max())
    nms_card = vision.detection_nms(*dec_card, nms_threshold=0.45)
    nms_cpu = vision.detection_nms(*[d.cpu() for d in dec_card],
                                   nms_threshold=0.45)
    out["nms_equal"] = bool(torch.equal(nms_card.cpu(), nms_cpu))

    def detect(ctx, a):
        return nd.contrib.MultiBoxDetection(
            nd.array(probs[:b], ctx=ctx), nd.array(loc[:b], ctx=ctx), a,
            nms_threshold=0.45, threshold=0.01)

    dets = detect(gpu, anchors).asnumpy()
    t0 = time.perf_counter()
    own = detect(cpu, anchors_cpu).asnumpy()
    out["detect_cpu_ms"] = (time.perf_counter() - t0) * 1e3
    out["op_equal_to_parts"] = bool(np.array_equal(dets, nms_card.cpu()
                                                   .numpy()))
    out["kept_per_image"] = (dets[:, :, 0] >= 0).sum(1).tolist()
    out["own_rows_apart"] = int((np.abs(dets - own) > 1e-5).any(2).sum())
    out["detect_ms"] = det_time(lambda: detect(gpu, anchors))
    out["prior_ms"] = det_time(lambda: dn.ssd300_anchors(mx, gpu))
    out["launches"] = read_launches()
    log("[det] %s: det_ssd300_heads: MultiBoxPrior over the maps %s: %d "
        "anchors, equal to the CPU's %s, %.3f ms; MultiBoxTarget at batch "
        "%d (1-8 boxes an image, %d positive anchors): box targets %.3g of "
        "the largest from the CPU's (bound %g), masks equal %s, classes "
        "equal %s, %.3f ms on the card and %.3f on the CPU (best of %d); "
        "MultiBoxDetection at batch %d over %d classes (NMS 0.45, "
        "threshold 0.01): decoded classes equal %s, scores equal %s, boxes "
        "%.3g apart, the NMS of the card's boxes equal on the card and the "
        "CPU %s, the op equal to its parts %s, kept per image %s (the CPU's "
        "own decoding moves %d rows), %.3f ms on the card (best of %d) "
        "and %.3f on the CPU (one call; host clock); flash-attention "
        "launches %s"
        % (card(), dn.SSD300_MAPS, out["anchors"], out["anchors_equal"],
           out["prior_ms"], DET_TARGET_BATCH, out["positives"],
           out["target_box_err"], DET_BOX_TOL, out["target_mask_equal"],
           out["target_cls_equal"], out["target_ms"], out["target_cpu_ms"],
           DET_REPEAT, b, dn.CLASSES, out["decode_cls_equal"],
           out["decode_score_equal"], out["decode_box_err"],
           out["nms_equal"],
           out["op_equal_to_parts"], out["kept_per_image"],
           out["own_rows_apart"], out["detect_ms"], DET_REPEAT,
           out["detect_cpu_ms"], out["launches"]))
    for key in ("target_mask_equal", "target_cls_equal", "decode_cls_equal",
                "decode_score_equal", "nms_equal", "op_equal_to_parts"):
        if not out[key]:
            fail("det: SSD300's heads on the card and the CPU differ: %s "
                 "is false" % key)
    for key in ("target_box_err", "decode_box_err"):
        if not out[key] <= DET_BOX_TOL:
            fail("det: SSD300's %s is %g (bound %g)" % (key, out[key],
                                                        DET_BOX_TOL))
    if any(out["launches"].values()):
        fail("det: SSD300's heads launched a flash-attention kernel")
    return out


def phase_det():
    """The two detection examples, the Faster R-CNN VGG16 row and SSD300's
    heads on the card; returns the rows."""
    t0 = time.monotonic()
    dn = det_module()
    zero_launches()
    rows = det_examples()
    zero_launches()
    rows["det_frcnn_vgg16"] = det_frcnn_vgg16_row(dn)
    zero_launches()
    rows["det_ssd300_heads"] = det_ssd300_heads(dn)
    log("[det] %s: flash-attention launches by row %s; the phase took "
        "%.1f s" % (card(), {k: r["launches"] for k, r in rows.items()},
                    time.monotonic() - t0))
    return rows


# ---------------------------------------------------------------------------
# quant: INT8 post-training quantization of ResNet-50 v1, the Conv+BN
# fold, the two examples of the slice, and dgl sampling at Pubmed's size
# ---------------------------------------------------------------------------

# imagenet_gen_qsym.py's defaults: 10 calibration batches of 32, the
# first convolution excluded; inference timed at batch 64
QUANT_CALIB_BATCHES, QUANT_CALIB_BATCH = 10, 32
QUANT_BATCH, QUANT_SIDE = 64, 224
QUANT_WARM, QUANT_ITERS = 2, 10
QUANT_SEED = 0
# the folded graph's logits against the unfolded graph's (relative L2):
# each weight is rescaled in float32 (W * gamma / sqrt(var + eps)), one
# rounding a weight, carried through 53 convolutions
QUANT_FOLD_TOL = 1e-4
QUANT_EXAMPLE = "quantization/quantize_model.py"
CUSTOM_EXAMPLE = "numpy-ops/custom_softmax.py"
CUSTOM_K = 4
# the fused loop's weights against the per-step steps' (relative L2):
# the same ops on the card, step by step
CUSTOM_LOOP_TOL = 1e-6
# Planetoid's Pubmed: 19,717 vertices, 44,338 undirected edges (stored
# both ways in the dense (V, V) edge-id layout: 1.55 GB of float32)
DGL_V, DGL_EDGES = 19717, 44338
DGL_SEEDS, DGL_HOPS, DGL_NEIGHBORS, DGL_MAX = 1000, 2, 10, 8192
DGL_REPEAT = 3


def quant_params(symbol, side, seed=QUANT_SEED):
    """ResNet-50 v1's weights from ``seed`` (He normal, zero biases and
    betas, unit gammas; moving means 0 and variances 1), on the card."""
    gpu = mx.gpu(0)
    arg_shapes, _, aux_shapes = symbol.infer_shape(
        data0=(1, 3, side, side), softmax_label=(1,))
    rng = np.random.RandomState(seed)
    args, aux = {}, {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in ("data0", "softmax_label"):
            continue
        if name.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            v = rng.normal(0, np.sqrt(2.0 / fan_in), shape)
        elif name.endswith("gamma"):
            v = np.ones(shape)
        else:
            v = np.zeros(shape)
        args[name] = mx.nd.array(v.astype(np.float32), ctx=gpu)
    for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
        v = np.ones(shape) if name.endswith("var") else np.zeros(shape)
        aux[name] = mx.nd.array(v.astype(np.float32), ctx=gpu)
    return args, aux


def quant_bind(symbol, args, aux, batch, side):
    """``symbol`` bound on the card for inference at ``batch``, with the
    parameters' own shapes and dtypes (int8 tables, (1,) ranges)."""
    names = set(symbol.list_arguments())
    shapes = {k: tuple(v.shape) for k, v in args.items() if k in names}
    shapes["data0"] = (batch, 3, side, side)
    if "softmax_label" in names:
        shapes["softmax_label"] = (batch,)
    exe = symbol.simple_bind(ctx=mx.gpu(0), grad_req="null",
                             type_dict={k: v.dtype for k, v in args.items()
                                        if k in names}, **shapes)
    exe.copy_params_from(args, aux, allow_extra_params=True)
    return exe


def quant_infer_row(tag, exe, x):
    """ms a batch-``QUANT_BATCH`` forward (host clock, synchronised),
    images/s, busy, idle share, operations and peak memory of one bound
    graph."""
    def fwd():
        return exe.forward(is_train=False, data0=x)[0]

    torch.cuda.reset_peak_memory_stats()
    for _ in range(QUANT_WARM):
        fwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(QUANT_ITERS):
        out = fwd()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / QUANT_ITERS
    spans = device_spans(fwd)
    busy, window, top = profile_summary(spans, top=5)
    peak = torch.cuda.max_memory_allocated() / 1e6
    x_batch = x.shape[0]
    log("[quant] %s: %s, batch %d: %.3f ms a batch, %.1f images/s; one "
        "profiled forward: busy %.3f ms in a %.3f ms window (idle share at "
        "most %.3f), %d device operations, most time %s; peak %.1f MB"
        % (card(), tag, x_batch, ms, x_batch / ms * 1e3, busy, window,
           1 - busy / window, len(spans),
           [(n[:40], round(us, 1)) for n, us in top], peak))
    return out.asnumpy(), dict(ms=ms, images_per_sec=x_batch / ms * 1e3,
                               busy_ms=busy, idle=1 - busy / window,
                               ops=len(spans), peak_mb=peak)


QUANT_OPS = ("_contrib_quantized_conv", "_contrib_quantized_fully_connected")


def quant_layer_check(qsym, qargs, qaux, x):
    """Every quantized convolution and FC of ``qsym`` fed the card's own
    int8 input (and ranges) from one forward: its int32 accumulator
    against the plain float64 product on the same inputs, which must be
    equal.  Returns (nodes checked, nodes unequal, largest |difference|)."""
    from mxtpu_torch.ops import quantization as tq

    qnodes = [n for n in qsym._topo()
              if not n.is_variable and n.op.name in QUANT_OPS]
    entries, seen = [], set()
    for n in qnodes:
        for e in list(n.inputs) + [(n, 0)]:
            if not e[0].is_variable and (id(e[0]), e[1]) not in seen:
                seen.add((id(e[0]), e[1]))
                entries.append(e)
    group = mx.sym.Symbol(entries)
    exe = quant_bind(group, qargs, qaux, x.shape[0], x.shape[2])
    outs = exe.forward(is_train=False, data0=x)
    val = {(id(e[0]), e[1]): o._data for e, o in zip(entries, outs)}

    def value(entry):
        node, idx = entry
        return exe.arg_dict[node.name]._data if node.is_variable \
            else val[(id(node), idx)]

    bad, worst = 0, 0
    for n in qnodes:
        ins = [value(e) for e in n.inputs]
        data, weight, bias = ins[0], ins[1], ins[2]
        ranges = ins[3:7]
        b_ranges = ins[7:9] if len(ins) >= 9 else [None, None]
        a = n.attrs
        if n.op.name == "_contrib_quantized_conv":
            ns = len(a["kernel"])
            want = tq.plain_conv(data, weight,
                                 tq._norm(a.get("stride"), ns, 1),
                                 tq._norm(a.get("dilate"), ns, 1),
                                 tq._norm(a.get("pad"), ns, 0),
                                 int(a.get("num_group", 1)))
            shape = (1, -1) + (1,) * ns
        else:
            flat = data.reshape(data.shape[0], -1) \
                if a.get("flatten", True) else data
            want = tq.plain_matmul(flat, weight.t())
            shape = (1, -1)
        if not a.get("no_bias", False):
            want = want + tq._rescaled_bias(
                bias, *ranges, *b_ranges).reshape(shape)
        got = val[(id(n), 0)]
        if got.dtype != torch.int32 or not torch.equal(got, want):
            bad += 1
            worst = max(worst, int((got.long() - want.long()).abs().max()))
    del exe, outs, val
    return len(qnodes), bad, worst


def quant_first_conv_check(symbol, args, x):
    """The excluded first convolution (K = 3 x 7 x 7 = 147) quantized on
    the card: its int8 route against the plain float64 version."""
    from mxtpu_torch.ops import quantization as tq

    conv = [n for n in symbol._topo()
            if not n.is_variable and n.op.name == "Convolution"][0]
    nd = mx.nd.contrib
    q, lo, hi = nd.quantize_v2(x)
    w, wlo, whi = nd.quantize_v2(args[conv.inputs[1][0].name])
    a = conv.attrs
    acc = nd.quantized_conv(q, w, w, lo, hi, wlo, whi, kernel=a["kernel"],
                            stride=a.get("stride", ()), pad=a.get("pad", ()),
                            num_filter=a["num_filter"], no_bias=True)[0]
    want = tq.plain_conv(q._data, w._data, tq._norm(a.get("stride"), 2, 1),
                         (1, 1), tq._norm(a.get("pad"), 2, 0))
    return conv.name, bool(torch.equal(acc._data, want))


def quant_resnet50(symbol, args, aux):
    """Row quant_resnet50_int8: calibration in both modes, the int8, fp32
    and bf16 graphs timed at QUANT_BATCH, the layer-by-layer check."""
    from mxtpu_torch.contrib import quantization as cq
    from mxtpu_torch.ops import quantization as tq

    gpu = mx.gpu(0)
    first = [n.name for n in symbol._topo()
             if not n.is_variable and n.op.name == "Convolution"][0]
    rng = np.random.RandomState(QUANT_SEED + 1)
    n_calib = QUANT_CALIB_BATCHES * QUANT_CALIB_BATCH
    images = rng.rand(n_calib, 3, QUANT_SIDE, QUANT_SIDE).astype(np.float32)
    calib = mx.io.NDArrayIter({"data0": images}, batch_size=QUANT_CALIB_BATCH,
                              ctx=gpu)
    row, graphs = {}, {}
    for mode in ("naive", "entropy"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        graphs[mode] = cq.quantize_model(
            symbol, args, aux, data_names=("data0",),
            label_names=("softmax_label",), ctx=gpu,
            excluded_sym_names=(first,), calib_mode=mode, calib_data=calib,
            num_calib_examples=n_calib)
        row["calib_%s_s" % mode] = time.monotonic() - t0
    del images, calib
    qsym, qargs, qaux = graphs["entropy"]
    ops = [n.op.name for n in qsym._topo() if not n.is_variable]
    row["quantized_nodes"] = ops.count("_contrib_quantize_v2")
    devices = {str(v.ctx) for v in list(qargs.values()) + list(qaux.values())}
    log("[quant] %s: quantize_model over %d batches of %d at %d² (first "
        "convolution %s excluded): naive %.1f s, entropy %.1f s; %d "
        "quantized nodes (%d convolutions, %d FC); parameters on %s"
        % (card(), QUANT_CALIB_BATCHES, QUANT_CALIB_BATCH, QUANT_SIDE, first,
           row["calib_naive_s"], row["calib_entropy_s"],
           row["quantized_nodes"], ops.count(QUANT_OPS[0]),
           ops.count(QUANT_OPS[1]), sorted(devices)))
    if devices != {str(gpu)} or not row["quantized_nodes"]:
        fail("quant: the quantized parameters on %s, %d quantized nodes"
             % (sorted(devices), row["quantized_nodes"]))
    x = mx.nd.array(np.random.RandomState(QUANT_SEED + 2).rand(
        QUANT_BATCH, 3, QUANT_SIDE, QUANT_SIDE).astype(np.float32), ctx=gpu)
    exe = quant_bind(qsym, qargs, qaux, QUANT_BATCH, QUANT_SIDE)
    before = tq.INT8_LAUNCHES["int8_gemm"]
    exe.forward(is_train=False, data0=x)
    torch.cuda.synchronize()
    row["int8_gemm_a_forward"] = tq.INT8_LAUNCHES["int8_gemm"] - before
    p8, row["int8"] = quant_infer_row("quant_resnet50_int8 (int8 graph)",
                                      exe, x)
    del exe
    free_card()
    exe = quant_bind(symbol, args, aux, QUANT_BATCH, QUANT_SIDE)
    p32, row["fp32"] = quant_infer_row("quant_resnet50_int8 (fp32 graph, "
                                       "TF32 off)", exe, x)
    del exe
    free_card()
    with mx.amp.scope("bfloat16"):
        exe = quant_bind(symbol, args, aux, QUANT_BATCH, QUANT_SIDE)
    _, row["bf16"] = quant_infer_row("quant_resnet50_int8 (bf16 graph)",
                                     exe, x)
    del exe
    free_card()
    pn = quant_bind(graphs["naive"][0], graphs["naive"][1],
                    graphs["naive"][2], QUANT_BATCH, QUANT_SIDE) \
        .forward(is_train=False, data0=x)[0].asnumpy()
    for name, p in (("entropy", p8), ("naive", pn)):
        row["%s_rel_err" % name] = float(np.abs(p - p32).max()
                                         / np.abs(p32).max())
        row["%s_top1_agree" % name] = float((p.argmax(1) ==
                                             p32.argmax(1)).mean())
    checked, bad, worst = quant_layer_check(qsym, qargs, qaux, x)
    first_name, first_ok = quant_first_conv_check(symbol, args, x)
    row.update(layers_checked=checked, layers_unequal=bad,
               first_conv_exact=first_ok)
    log("[quant] %s: quant_resnet50_int8: %d int8 products a forward on "
        "torch._int_mm; softmax against fp32 (not gated): entropy largest "
        "error %.4g of the largest probability, top-1 agreement %.3f; naive "
        "%.4g, %.3f; layer by layer, %d quantized convolutions and FCs fed "
        "the card's int8 inputs: %d int32 accumulators differ from the "
        "float64 plain version (largest |difference| %d); %s quantized "
        "(K = 147) exact: %s"
        % (card(), row["int8_gemm_a_forward"], row["entropy_rel_err"],
           row["entropy_top1_agree"], row["naive_rel_err"],
           row["naive_top1_agree"], checked, bad, worst, first_name,
           first_ok))
    if bad or not first_ok or not checked:
        fail("quant: %d of %d int32 accumulators differ from the float64 "
             "plain version; the first convolution exact: %s"
             % (bad, checked, first_ok))
    if row["int8_gemm_a_forward"] != checked:
        fail("quant: %d int8 products in a forward of %d quantized nodes"
             % (row["int8_gemm_a_forward"], checked))
    del graphs, qargs, qaux, x
    free_card()
    return row


def quant_convbn_fold(symbol, args, aux):
    """Row quant_convbn_fold: optimize_for("TPU") folds every inference
    BatchNorm into its convolution; the logits against the unfolded
    graph's within QUANT_FOLD_TOL; both timed."""
    fc = [n.name for n in symbol._topo()
          if not n.is_variable and n.op.name == "FullyConnected"][-1]
    t0 = time.monotonic()
    fsym, fargs, faux = symbol.optimize_for("TPU", args=dict(args),
                                            aux=dict(aux))
    fold_s = time.monotonic() - t0
    bns = [sum(n.op.name == "BatchNorm" for n in s._topo()
               if not n.is_variable) for s in (symbol, fsym)]
    x = mx.nd.array(np.random.RandomState(QUANT_SEED + 3).rand(
        QUANT_BATCH, 3, QUANT_SIDE, QUANT_SIDE).astype(np.float32),
        ctx=mx.gpu(0))
    row = dict(fold_s=fold_s, bn_before=bns[0], bn_after=bns[1])
    logits = []
    for tag, s, a, b in (("unfolded", symbol, args, aux),
                         ("folded", fsym, fargs, faux)):
        exe = quant_bind(s, a, b, QUANT_BATCH, QUANT_SIDE)
        _, row[tag] = quant_infer_row("quant_convbn_fold (%s, fp32)" % tag,
                                      exe, x)
        head = quant_bind(s.get_internals()[fc + "_output"], a, b,
                          QUANT_BATCH, QUANT_SIDE)
        logits.append(head.forward(is_train=False, data0=x)[0].asnumpy()
                      .astype(np.float64))
        del exe, head
        free_card()
    row["rel_l2"] = float(np.linalg.norm(logits[1] - logits[0])
                          / np.linalg.norm(logits[0]))
    log("[quant] %s: quant_convbn_fold: %d BatchNorms folded in %.2f s (%d "
        "left); the logits' relative L2 against the unfolded graph %.3g "
        "(bound %g); %.3f ms a batch against %.3f"
        % (card(), bns[0] - bns[1], fold_s, bns[1], row["rel_l2"],
           QUANT_FOLD_TOL, row["folded"]["ms"], row["unfolded"]["ms"]))
    if bns[1] or not row["rel_l2"] <= QUANT_FOLD_TOL:
        fail("quant: the fold left %d BatchNorms; logits %.3g from the "
             "unfolded graph's" % (bns[1], row["rel_l2"]))
    return row


def quant_examples():
    """Rows quant_example (examples/quantization/quantize_model.py in
    both calibration modes, every executor's arrays on the card) and
    custom_softmax (examples/numpy-ops/custom_softmax.py, ms a batch)."""
    devices = set()
    bind = mx.sym.Symbol.simple_bind

    def bind_spy(self, *a, **kw):
        exe = bind(self, *a, **kw)
        devices.update(str(v.ctx) for v in exe.arg_arrays + exe.aux_arrays)
        return exe

    rows = {"quant_example": {}}
    mx.sym.Symbol.simple_bind = bind_spy
    try:
        for mode in ("naive", "entropy"):
            zero_launches()
            out, lines, secs = example_run(QUANT_EXAMPLE,
                                           ["--calib-mode", mode], "quant")
            agree = [float(ln.rsplit(":", 1)[1]) for ln in lines
                     if "top-1 agreement" in ln]
            rows["quant_example"][mode] = dict(seconds=secs, agreement=agree,
                                               launches=read_launches())
    finally:
        mx.sym.Symbol.simple_bind = bind
    rows["quant_example"]["devices"] = sorted(devices)
    rows["quant_example"]["launches"] = {
        k: sum(r["launches"][k] for m, r in rows["quant_example"].items()
               if m in ("naive", "entropy")) for k in KERNELS}
    log("[quant] %s: quant_example (%s, 3 epochs): naive %.1f s, agreement "
        "%s; entropy %.1f s, agreement %s; executors' arrays on %s"
        % (card(), QUANT_EXAMPLE, rows["quant_example"]["naive"]["seconds"],
           rows["quant_example"]["naive"]["agreement"],
           rows["quant_example"]["entropy"]["seconds"],
           rows["quant_example"]["entropy"]["agreement"], sorted(devices)))
    if devices != {str(mx.gpu(0))}:
        fail("quant: %s's executors held arrays on %s"
             % (QUANT_EXAMPLE, sorted(devices)))
    zero_launches()
    out, lines, secs = example_run(CUSTOM_EXAMPLE, ["--epochs", "5"],
                                   "quant")
    costs = [float(ln.rsplit("=", 1)[1]) for ln in lines
             if "Time cost=" in ln]
    batches = 1024 // 64
    rows["custom_softmax"] = dict(
        seconds=secs, epoch_s=costs,
        ms_a_batch=min(costs) / batches * 1e3 if costs else None,
        launches=read_launches())
    log("[quant] %s: custom_softmax (%s, 5 epochs): %.1f s; ms a batch "
        "%.3f (the fastest epoch's time over its %d batches); epochs %s"
        % (card(), CUSTOM_EXAMPLE, secs,
           rows["custom_softmax"]["ms_a_batch"] or float("nan"), batches,
           ["%.3f" % c for c in costs]))
    if not costs:
        fail("quant: %s printed no epoch" % CUSTOM_EXAMPLE)
    return rows


def custom_loop_check():
    """A FusedTrainLoop (K = CUSTOM_K) over the custom softmax's network
    on the card against K per-step steps from the same state: never
    captured, the weights within CUSTOM_LOOP_TOL."""
    example_module(CUSTOM_EXAMPLE, "quant")  # registers custom_softmax
    gpu = mx.gpu(0)
    s = mx.sym
    h = s.FullyConnected(s.Variable("data"), num_hidden=64, name="fc1")
    h = s.FullyConnected(s.Activation(h, act_type="relu"), num_hidden=10,
                         name="fc2")
    net = s.Custom(h, s.Variable("softmax_label"), op_type="custom_softmax",
                   name="softmax")
    rng = np.random.RandomState(QUANT_SEED)
    init = {"fc1_weight": rng.normal(0, 0.1, (64, 64)),
            "fc1_bias": np.zeros(64), "fc2_weight": rng.normal(0, 0.1,
                                                             (10, 64)),
            "fc2_bias": np.zeros(10)}
    batches = [mx.io.DataBatch(
        [mx.nd.array(rng.rand(64, 64).astype(np.float32), ctx=gpu)],
        [mx.nd.array(rng.randint(0, 10, 64).astype(np.float32), ctx=gpu)])
        for _ in range(CUSTOM_K)]
    weights = []
    for fused in (False, True):
        mod = mx.mod.Module(net, context=gpu, label_names=("softmax_label",))
        mod.bind(data_shapes=[("data", (64, 64))],
                 label_shapes=[("softmax_label", (64,))])
        mod.init_params(arg_params={k: mx.nd.array(v.astype(np.float32),
                                                   ctx=gpu)
                                    for k, v in init.items()})
        mod.init_optimizer(optimizer="sgd", kvstore=None,
                           optimizer_params={"learning_rate": 0.1})
        if fused:
            loop = mx.FusedTrainLoop(mod, steps_per_program=CUSTOM_K)
            loop.run(batches)
            torch.cuda.synchronize()
        else:
            for b in batches:
                mod.forward(b, is_train=True)
                mod.backward()
                mod.update()
        args, _ = mod.get_params()
        weights.append(np.concatenate([args[k].asnumpy().ravel()
                                       for k in sorted(init)]))
    rel = float(np.linalg.norm(weights[1] - weights[0])
                / np.linalg.norm(weights[0]))
    moved = float(np.linalg.norm(weights[0] - np.concatenate(
        [init[k].ravel() for k in sorted(init)])))
    log("[quant] %s: custom_softmax: FusedTrainLoop K=%d over the Custom "
        "graph: captured %s (capturable %s); weights against %d per-step "
        "steps: relative L2 %.3g (bound %g), bitwise %s; the steps moved "
        "them by %.4f" % (card(), CUSTOM_K, loop.captures, loop.capturable,
                          CUSTOM_K, rel, CUSTOM_LOOP_TOL,
                          bool(np.array_equal(weights[0], weights[1])),
                          moved))
    if loop.capturable or loop.captures or not rel <= CUSTOM_LOOP_TOL \
            or not moved > 0:
        fail("quant: the FusedTrainLoop over a Custom graph: captures %d, "
             "weights %.3g from the per-step steps'" % (loop.captures, rel))
    return dict(loop_rel_l2=rel, captures=loop.captures)


def dgl_graph(seed=QUANT_SEED):
    """A Pubmed-sized graph from ``seed``: DGL_EDGES distinct undirected
    edges without self-loops, each stored both ways, as (src, dst) with
    edge ids 0..2E-1 in that order."""
    rng = np.random.RandomState(seed)
    pairs = set()
    while len(pairs) < DGL_EDGES:
        u = rng.randint(0, DGL_V, 2 * DGL_EDGES)
        v = rng.randint(0, DGL_V, 2 * DGL_EDGES)
        for a, b in zip(u, v):
            if a != b and len(pairs) < DGL_EDGES:
                pairs.add((min(a, b), max(a, b)))
    e = np.asarray(sorted(pairs), np.int64)
    return np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1],
                                                               e[:, 0]])


def dgl_time(fn):
    """Host ms a call of fn, synchronised (its outputs stay on the card),
    the best of DGL_REPEAT after a warm call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(DGL_REPEAT):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def dgl_sample_pubmed():
    """Row dgl_sample_pubmed: both neighbor samplers on the card at
    Pubmed's size, their contracts, the induced subgraph against the
    CPU's, and the sampler fed the card's draws against the CPU's."""
    from mxtpu_torch.ops import dgl as tdgl

    gpu, cpu = mx.gpu(0), mx.cpu()
    dev = gpu.torch_device
    free_card()
    src, dst = dgl_graph()
    g = torch.zeros((DGL_V, DGL_V), dtype=torch.float32, device=dev)
    g[torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)] = \
        torch.arange(1, len(src) + 1, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(QUANT_SEED + 4)
    prob = rng.uniform(0.1, 1.0, DGL_V).astype(np.float32)
    seeds = rng.choice(DGL_V, DGL_SEEDS, replace=False).astype(np.int64)
    G, S = mx.nd.NDArray(g), mx.nd.array(seeds, ctx=gpu, dtype=np.int64)
    P = mx.nd.array(prob, ctx=gpu)
    attrs = dict(num_hops=DGL_HOPS, num_neighbor=DGL_NEIGHBORS,
                 max_num_vertices=DGL_MAX)
    nd = mx.nd.contrib
    row = {}
    g_host = g.cpu().numpy()
    for name, fn, extra in (
            ("uniform", nd.dgl_csr_neighbor_uniform_sample, []),
            ("non_uniform", nd.dgl_csr_neighbor_non_uniform_sample, [P])):
        torch.cuda.reset_peak_memory_stats()
        mx.random.seed(QUANT_SEED)
        out = fn(G, *extra, S, **attrs)
        res = [o.asnumpy() for o in out]
        ms = dgl_time(lambda: fn(G, *extra, S, **attrs))
        peak = torch.cuda.max_memory_allocated() / 1e9
        verts, lay = res[0], res[2]
        valid = verts >= 0
        counts = [int((lay[valid] == h).sum()) for h in range(DGL_HOPS + 1)]
        bad = []
        if sorted(verts[valid][lay[valid] == 0]) != sorted(seeds):
            bad.append("layer 0 is not the seeds")
        for h in range(1, DGL_HOPS + 1):
            prev = verts[valid & (lay == h - 1)]
            cur = verts[valid & (lay == h)]
            if len(cur) > DGL_NEIGHBORS * len(prev):
                bad.append("hop %d added %d from %d" % (h, len(cur),
                                                        len(prev)))
            reach = (g_host[np.ix_(prev, cur)] != 0).any(0)
            if not reach.all():
                bad.append("%d vertices of hop %d without an edge from hop "
                           "%d" % (int((~reach).sum()), h, h - 1))
        if extra and not np.array_equal(
                res[3], np.where(valid, prob[np.clip(verts, 0, None)], 0)):
            bad.append("the weights are not the vertices' probabilities")
        sub_card = nd.dgl_subgraph(G, out[0], num_args=2,
                                   return_mapping=True)
        sub_cpu = nd.dgl_subgraph(mx.nd.array(g_host, ctx=cpu),
                                  mx.nd.array(verts, ctx=cpu,
                                              dtype=np.int64),
                                  num_args=2, return_mapping=True)
        sub_equal = all(np.array_equal(a.asnumpy(), b.asnumpy())
                        for a, b in zip(sub_card, sub_cpu))
        # the sampler's subgraph holds the parent's edge ids: the mapping
        if not sub_equal or not np.array_equal(sub_card[1].asnumpy(),
                                               res[1]):
            bad.append("the induced subgraph differs from the CPU's")
        row[name] = dict(ms=ms, peak_gb=peak, sampled=int(valid.sum()),
                         by_hop=counts, subgraph_equal=sub_equal)
        log("[quant] %s: dgl_sample_pubmed %s (V %d, %d edges both ways, "
            "%d seeds, %d hops x %d, max %d): %.2f ms a call (best of %d), "
            "peak %.2f GB; %d vertices by hop %s; induced subgraph equal to "
            "the CPU's: %s" % (card(), name, DGL_V, len(src), DGL_SEEDS,
                               DGL_HOPS, DGL_NEIGHBORS, DGL_MAX, ms,
                               DGL_REPEAT, peak, int(valid.sum()), counts,
                               sub_equal))
        if bad:
            fail("quant: dgl_sample_pubmed %s: %s" % (name, bad))
        del out, sub_card, sub_cpu
    gen = mx.random.generator(gpu)
    draws = tdgl.sample_draws(gen, DGL_HOPS, DGL_V, g.device)
    st = torch.as_tensor(seeds, device=g.device)
    pt = torch.as_tensor(prob, device=g.device)
    card_out = tdgl.neighbor_sample(g, st, pt, draws, DGL_NEIGHBORS, DGL_MAX)
    card_out = [o.cpu() for o in card_out]
    draws = [d.cpu() for d in draws]
    del g
    free_card()
    t0 = time.monotonic()
    cpu_out = tdgl.neighbor_sample(torch.from_numpy(g_host), st.cpu(),
                                   pt.cpu(), draws, DGL_NEIGHBORS, DGL_MAX)
    row["cpu_sampler_s"] = time.monotonic() - t0
    row["sampler_equal"] = all(torch.equal(a, b)
                               for a, b in zip(card_out, cpu_out))
    log("[quant] %s: dgl_sample_pubmed: the weighted sampler fed the card's "
        "draws, on the card and on the CPU (%.1f s): vertices, subgraph and "
        "layers equal: %s" % (card(), row["cpu_sampler_s"],
                              row["sampler_equal"]))
    if not row["sampler_equal"]:
        fail("quant: the sampler on the card differs from the CPU's on the "
             "same draws")
    del draws, card_out, cpu_out, g_host
    free_card()
    return row


def phase_quant():
    """The INT8 ResNet-50 v1, the Conv+BN fold, the two examples of the
    slice, a FusedTrainLoop over a Custom graph and dgl sampling at
    Pubmed's size, on the card; returns the rows."""
    t0 = time.monotonic()
    free_card()
    symbol = mx.sym.ZOO["resnet50_v1"]()
    args, aux = quant_params(symbol, QUANT_SIDE)
    rows = {}
    zero_launches()
    rows["quant_resnet50_int8"] = quant_resnet50(symbol, args, aux)
    rows["quant_resnet50_int8"]["launches"] = read_launches()
    zero_launches()
    rows["quant_convbn_fold"] = quant_convbn_fold(symbol, args, aux)
    rows["quant_convbn_fold"]["launches"] = read_launches()
    del args, aux
    free_card()
    rows.update(quant_examples())
    zero_launches()
    rows["custom_softmax"]["loop"] = custom_loop_check()
    rows["custom_softmax"]["launches"] = {
        k: rows["custom_softmax"]["launches"][k] + v
        for k, v in read_launches().items()}
    zero_launches()
    rows["dgl_sample_pubmed"] = dgl_sample_pubmed()
    rows["dgl_sample_pubmed"]["launches"] = read_launches()
    for name, r in rows.items():
        if any(r["launches"].values()):
            fail("quant: %s launched a flash-attention kernel: %s"
                 % (name, r["launches"]))
    log("[quant] %s: flash-attention launches by row %s; the phase took "
        "%.1f s" % (card(), {k: r["launches"] for k, r in rows.items()},
                    time.monotonic() - t0))
    return rows


# ---------------------------------------------------------------------------
# a10c: the Monitor in train_imagenet.py, a channels-last ResNet-50,
# ragged serving after warmup, contexts and the dependency engine
# ---------------------------------------------------------------------------

# train_imagenet.py's --monitor over one epoch of 30 batches: the
# monitor arms at batches 0, 10 and 20
A10C_MONITOR_ARGS = ["--monitor", "10", "--max-batches", "30",
                     "--num-epochs", "1"]
A10C_MONITOR_AT = (0, 10, 20)
A10C_MONITOR_TOL = 1e-5      # a printed |x| mean against float64's, relative
NHWC_BATCH, NHWC_WARM, NHWC_STEPS = 128, 2, 8
NHWC_POOL = 3                # host batches the PrefetchingIter cycles through
NHWC_CHECK_BATCH = 8
NHWC_LAYOUT_TOL = 1e-9       # float64 NHWC against NCHW, relative L2
# the kernels of a layout copy: cuDNN's own conversions and torch's copies
LAYOUT_COPY_KEYS = ("nchwToNhwc", "nhwcToNchw", "direct_copy", "copy_kernel",
                    "transpose")
RAGGED_BATCH = 128
RAGGED_SIZES = (1, 37, 64, 100, 128)
RAGGED_TOL = RESNET_OUT_TOL  # a padded forward against the exact one
LENET_TRAIN, LENET_TEST, LENET_BATCH = 6000, 1000, 64
PIN_MB = 256


def a10c_imagenet_monitor():
    """Row imagenet_monitor: train_imagenet.py with --monitor 10 over 30
    batches; every value the Monitor prints against |x|'s mean in
    float64 of the same executor outputs on the card; ms a step of the
    monitored batches and of the others (Speedometer's batch ends)."""
    free_card()
    tmp = tempfile.mkdtemp(prefix="a10c_imagenet_")
    checks = []
    real_toc = mx.monitor.Monitor.toc

    def checked_toc(mon):
        want = {}
        if mon.activated:
            for exe in mon.exes:
                for name, arr in zip(exe._symbol.list_outputs(),
                                     exe.outputs):
                    if mon.re_prog.match(name):
                        want[(mon.step, name)] = float(
                            arr._data.double().abs().mean())
        res = real_toc(mon)
        checks.extend((n - 1, k, float(v), want.get((n, k)))
                      for n, k, v in res)
        return res

    mx.random.seed(0)
    mx.monitor.Monitor.toc = checked_toc
    t0 = time.monotonic()
    try:
        mod, ends, _, lines = imagenet_run(os.path.join(tmp, "resnet50"),
                                           A10C_MONITOR_ARGS)
    finally:
        mx.monitor.Monitor.toc = real_toc
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.monotonic() - t0
    printed = [ln for ln in lines if ln.startswith("Batch:")]
    t = {nbatch: at for _, nbatch, at in ends}
    step_ms = {n: (t[n] - t[n - 1]) * 1e3 for n in t if n - 1 in t}
    mon_ms = [step_ms[n] for n in A10C_MONITOR_AT if n in step_ms]
    plain_ms = [v for n, v in step_ms.items() if n not in A10C_MONITOR_AT]
    worst = max((abs(v - w) / max(abs(w), 1e-30) for _, _, v, w in checks
                 if w is not None), default=float("inf"))
    row = dict(seconds=secs, printed=len(printed),
               at=sorted({n for n, _, _, _ in checks}),
               worst_rel=worst, monitored_ms=float(np.median(mon_ms)),
               plain_ms=float(np.median(plain_ms)))
    log("[a10c] %s: imagenet_monitor: train_imagenet.py %s (ResNet-50 v1, "
        "batch %d, fp32 with TF32 off): %.1f s; the Monitor printed %d "
        "lines at batches %s, e.g. %s; each value against |x|'s mean in "
        "float64 of the same outputs on the card: worst relative %.3g "
        "(bound %g); ms a step (host clock, median): monitored %.3f, "
        "others %.3f" % (card(), " ".join(A10C_MONITOR_ARGS), IMAGENET_BATCH,
                         secs, len(printed), row["at"],
                         printed[:1], worst, A10C_MONITOR_TOL,
                         row["monitored_ms"], row["plain_ms"]))
    if row["at"] != list(A10C_MONITOR_AT) or \
            len(printed) != len(checks) or not checks:
        fail("a10c: the Monitor printed at batches %s (%d lines, %d "
             "values), not at %s" % (row["at"], len(printed), len(checks),
                                     A10C_MONITOR_AT))
    if any(w is None for _, _, _, w in checks) or \
            not worst <= A10C_MONITOR_TOL:
        fail("a10c: the Monitor's values are off the recomputed ones by "
             "%.3g: %s" % (worst, checks))
    del mod
    free_card()
    return row


def resnet50_nhwc():
    """The resnet phase's graph channels-last: layout NHWC on every
    Convolution and Pooling, axis 3 on every BatchNorm, and one
    transpose of the NCHW input ``data0`` at its start; the parameters
    keep their names and shapes."""
    graph = json.loads(mx.sym.ZOO["resnet50_v1"]().tojson())
    for node in graph["nodes"]:
        if node["op"] in ("Convolution", "Pooling"):
            node["attrs"]["layout"] = json.dumps("NHWC")
        elif node["op"] == "BatchNorm":
            node["attrs"]["axis"] = json.dumps(3)
    cl = mx.sym.load_json(json.dumps(graph))
    return cl(data0=mx.sym.transpose(mx.sym.var("data0"), axes=(0, 2, 3, 1),
                                     name="nhwc_input"))


def resnet_weights():
    """ResNet-50 v1's parameters and aux states, Xavier after
    ``random.seed(0)``, on the card."""
    mod = resnet_module(2, mx.gpu(0))
    mx.random.seed(0)
    mod.init_params(initializer=mx.initializer.Xavier())
    return mod.get_params()


def host_batches(batch, n, seed):
    """A PrefetchingIter (on the process's engine) over ``n`` host
    batches of bench.py's synthetic images, cycled."""
    rng = np.random.RandomState(seed)
    data = rng.rand(n * batch, 3, 224, 224).astype(np.float32)
    label = rng.randint(0, 1000, n * batch).astype(np.float32)
    return mx.io.PrefetchingIter(mx.io.NDArrayIter(
        data, label, batch_size=batch, data_name="data0", ctx=mx.cpu()))


def next_batch(it):
    try:
        return it.next()
    except StopIteration:
        it.reset()
        return it.next()


def nhwc_layout_row(symbol, dtype, params, aux, it):
    """One layout's row: ResNet-50 trained through Module at NHWC_BATCH
    under the policy ``dtype`` (SGD momentum 0.9), its batches from the
    host through ``it``; NHWC_WARM warm and NHWC_STEPS timed steps (host
    clock, synchronised at the end), then one profiled step."""
    free_card()
    with mx.amp.scope(dtype):
        mod = mx.mod.Module(symbol, data_names=("data0",),
                            label_names=("softmax_label",),
                            context=mx.gpu(0))
        mod.bind(data_shapes=[("data0", (NHWC_BATCH, 3, 224, 224))],
                 label_shapes=[("softmax_label", (NHWC_BATCH,))])
    mod.init_params(arg_params=params, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.01, "momentum": 0.9})

    def step():
        mod.forward_backward(next_batch(it))
        mod.update()

    for _ in range(NHWC_WARM):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NHWC_STEPS):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / NHWC_STEPS * 1e3
    spans, host_calls = profile_call(step)
    busy = busy_us([(a, b) for a, b, _ in spans]) / 1e3
    window = (max(b for _, b, _ in spans) - min(a for a, _, _ in spans)) / 1e3
    copies = [(b - a) for a, b, n in spans
              if any(k in n for k in LAYOUT_COPY_KEYS)]
    out = mod.get_outputs()[0]._data
    row = dict(ms=ms, imgs_per_sec=NHWC_BATCH / ms * 1e3, busy_ms=busy,
               idle=1 - busy / window, ops=len(spans),
               host_calls=host_calls,
               kinds={k: v / 1e3 for k, v in by_kind(spans).items()},
               layout_copies=len(copies),
               layout_copy_ms=sum(copies) / 1e3,
               finite=bool(torch.isfinite(out.float()).all()))
    del mod, out
    free_card()
    return row


def nhwc_layers(nchw, nhwc, params, aux, x, y):
    """The float32 step layer by layer (as ``staged_grads`` does): each
    node of the NCHW graph in training mode gets the NCHW forward's
    inputs, and its NHWC twin (the node of the same name) the same
    values, channels-last where they are activations; each output, and
    each input's gradient under one random head gradient, held NHWC
    against NCHW.  So a ReLU or a max decides alike in both, where whole
    steps round apart.  Returns the worst relative L2 forward and
    backward, each with its node."""
    from mxtpu_torch.symbol.symbol import _topo_order

    dev = mx.gpu(0).torch_device
    twins = {n.name: n for n in _topo_order(nhwc._outputs)
             if not n.is_variable}
    values = dict({k: v._data for k, v in params.items()},
                  **{k: v._data for k, v in aux.items()},
                  data0=torch.as_tensor(x), softmax_label=torch.as_tensor(y))
    gen = torch.Generator(device=dev).manual_seed(5)
    env, worst = {}, {"forward": (0.0, None), "backward": (0.0, None)}

    def to_h(t):
        return t.permute(0, 2, 3, 1)

    def to_c(t):
        return t.permute(0, 3, 1, 2)

    def run(node, vals):
        attrs = dict(node.attrs)
        if node.op.train_aware:
            attrs["is_train"] = True
        with torch.enable_grad():
            return list(mx.ops.registry.invoke(node.op, vals, attrs))

    def note(kind, name, got, want):
        got, want = got.detach().double(), want.detach().double()
        err = float((got - want).norm() / max(float(want.norm()), 1e-30))
        if err > worst[kind][0]:
            worst[kind] = (err, name)

    for node in _topo_order(nchw._outputs):
        if node.is_variable:
            env[(id(node), 0)] = values[node.name].to(dev, torch.float32)
            continue
        ins = [env[(id(i), k)] for i, k in node.inputs]
        act = [t.dim() == 4 and (not i.is_variable or i.name == "data0")
               for (i, _), t in zip(node.inputs, ins)]
        xc = [t.detach().requires_grad_(t.is_floating_point()) for t in ins]
        xh = [(to_h(t) if a else t).detach().requires_grad_(
            t.is_floating_point()) for t, a in zip(ins, act)]
        out_c, out_h = run(node, xc), run(twins[node.name], xh)
        for j, (oc, oh) in enumerate(zip(out_c, out_h)):
            note("forward", "%s output %d" % (node.name, j), to_c(oh)
                 if oc.dim() == 4 and oc.shape != oh.shape else oh, oc)
            env[(id(node), j)] = oc.detach()
        wrt = [i for i, t in enumerate(xc) if t.requires_grad]
        if out_c[0].requires_grad and wrt:
            head = torch.randn(out_c[0].shape, generator=gen, device=dev)
            gc = torch.autograd.grad(out_c[0], [xc[i] for i in wrt], head,
                                     allow_unused=True)
            gh = torch.autograd.grad(
                out_h[0], [xh[i] for i in wrt],
                to_h(head) if out_h[0].shape != head.shape else head,
                allow_unused=True)
            for i, a, b in zip(wrt, gc, gh):
                if a is not None and b is not None:
                    note("backward", "%s input %d" % (node.name, i),
                         to_c(b) if act[i] else b, a)
    return worst


def nhwc_step_check(nchw, nhwc, params, aux):
    """One training step of both graphs from the same weights and batch
    at NHWC_CHECK_BATCH on the card (TF32 off).  In float64 the whole
    step of each layout, held together to NHWC_LAYOUT_TOL: at that
    precision no ReLU flips.  In float32, layer by layer
    (``nhwc_layers``), each output and input gradient within
    RESNET_OUT_TOL; the whole float32 steps against float64 are printed
    beside, not gated (a ReLU whose input lies within rounding of 0
    flips in one layout and not in the other)."""
    rng = np.random.RandomState(2)
    x = rng.rand(NHWC_CHECK_BATCH, 3, 224, 224)
    y = rng.randint(0, 1000, NHWC_CHECK_BATCH).astype(np.float64)

    def step(symbol, dtype):
        gpu = mx.gpu(0)
        ex = symbol.simple_bind(
            ctx=gpu, type_dict={n: dtype for n in symbol.list_arguments()},
            data0=x.shape, softmax_label=y.shape)
        ex.copy_params_from(params, aux)
        ex.forward(is_train=True, data0=mx.nd.array(x, ctx=gpu, dtype=dtype),
                   softmax_label=mx.nd.array(y, ctx=gpu, dtype=dtype))
        ex.backward()
        grads = {n: g._data.double() for n, g in ex.grad_dict.items()
                 if g is not None and n in params}
        return ex.outputs[0]._data.double(), grads

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def rel_all(ga, gb):
        num = sum(float((ga[k] - gb[k]).norm()) ** 2 for k in gb)
        den = sum(float(gb[k].norm()) ** 2 for k in gb)
        return (num / den) ** 0.5

    t0 = time.monotonic()
    ref_out, ref_g = step(nchw, "float64")
    out64, g64 = step(nhwc, "float64")
    out_c, g_c = step(nchw, "float32")
    out_h, g_h = step(nhwc, "float32")
    # a parameter's error against the whole gradient's scale: the conv
    # biases a BatchNorm follows have exact gradient 0, so their own
    # relative error is rounding over rounding
    floor = 1e-6 * max(float(g.norm()) for g in ref_g.values())

    def rel_floor(a, b):
        return float((a - b).norm()) / max(float(b.norm()), floor)

    worst = max(ref_g, key=lambda k: rel_floor(g64[k], ref_g[k]))
    layers = nhwc_layers(nchw, nhwc, params, aux, x.astype(np.float32),
                         y.astype(np.float32))
    res = dict(f64_out=rel(out64, ref_out), f64_grads=rel_all(g64, ref_g),
               f64_worst=(worst, rel_floor(g64[worst], ref_g[worst])),
               f32_out_nchw=rel(out_c, ref_out),
               f32_out_nhwc=rel(out_h, ref_out),
               f32_grads_nchw=rel_all(g_c, ref_g),
               f32_grads_nhwc=rel_all(g_h, ref_g), layers=layers)
    log("[a10c] %s: resnet50_nhwc step check at batch %d, %d parameters "
        "(relative L2): float64 whole step, NHWC against NCHW: output "
        "%.3g, all gradients %.3g, worst parameter %s %.3g (over the "
        "larger of its norm and 1e-6 of the largest; bound %g); "
        "float32 (TF32 off) layer by layer, NHWC against NCHW on the same "
        "inputs: worst output %.3g (%s), worst input gradient %.3g (%s) "
        "(bound %g); float32 whole steps against NCHW float64, not gated: "
        "output NCHW %.3g, NHWC %.3g; all gradients NCHW %.3g, NHWC %.3g; "
        "%.1f s" % (card(), NHWC_CHECK_BATCH, len(ref_g), res["f64_out"],
                    res["f64_grads"], worst, res["f64_worst"][1],
                    NHWC_LAYOUT_TOL, layers["forward"][0],
                    layers["forward"][1], layers["backward"][0],
                    layers["backward"][1], RESNET_OUT_TOL,
                    res["f32_out_nchw"], res["f32_out_nhwc"],
                    res["f32_grads_nchw"], res["f32_grads_nhwc"],
                    time.monotonic() - t0))
    if not (res["f64_out"] <= NHWC_LAYOUT_TOL
            and res["f64_grads"] <= NHWC_LAYOUT_TOL):
        fail("a10c: the NHWC ResNet-50's float64 step differs from the "
             "NCHW one: %s" % res)
    if not (layers["forward"][0] <= RESNET_OUT_TOL
            and layers["backward"][0] <= RESNET_OUT_TOL):
        fail("a10c: an NHWC layer differs from its NCHW twin: %s" % layers)
    free_card()
    return res


def a10c_nhwc_rows(params, aux):
    """Rows resnet50_nhwc_fp32 and resnet50_nhwc_bf16: the channels-last
    ResNet-50 beside the NCHW graph in the same run, each fed by a
    PrefetchingIter on the threaded engine; then the step check."""
    nchw, nhwc = mx.sym.ZOO["resnet50_v1"](), resnet50_nhwc()
    it = host_batches(NHWC_BATCH, NHWC_POOL, seed=0)
    rows = {}
    for name, dtype in (("resnet50_nhwc_fp32", None),
                        ("resnet50_nhwc_bf16", "bfloat16")):
        zero_launches()
        row = {"nhwc": nhwc_layout_row(nhwc, dtype, params, aux, it),
               "nchw": nhwc_layout_row(nchw, dtype, params, aux, it)}
        row["launches"] = read_launches()
        for layout in ("nhwc", "nchw"):
            r = row[layout]
            log("[a10c] %s: %s %s (batch %d, 224², %s, SGD momentum 0.9, "
                "batches from the host through PrefetchingIter): %.3f ms a "
                "step, %.2f images/s (host clock, %d steps); one profiled "
                "step: busy %.3f ms, idle share %.3f, %d device operations, "
                "%d launch calls; layout copies %d kernels, %.3f ms; device "
                "ms by kind %s" % (
                    card(), name, layout.upper(), NHWC_BATCH,
                    "bf16 through amp" if dtype else "fp32 with TF32 off",
                    r["ms"], r["imgs_per_sec"], NHWC_STEPS, r["busy_ms"],
                    r["idle"], r["ops"], r["host_calls"],
                    r["layout_copies"], r["layout_copy_ms"], ", ".join(
                        "%s %.3f" % kv for kv in sorted(r["kinds"].items()))))
            if not r["finite"]:
                fail("a10c: %s %s gave non-finite outputs" % (name, layout))
        rows[name] = row
    it.close()
    zero_launches()
    rows["resnet50_nhwc_fp32"]["check"] = nhwc_step_check(nchw, nhwc,
                                                         params, aux)
    rows["resnet50_nhwc_fp32"]["launches"] = {
        k: v + rows["resnet50_nhwc_fp32"]["launches"][k]
        for k, v in read_launches().items()}
    return rows


def a10c_ragged_serve(params, aux):
    """Row ragged_serve: a ResNet-50 Module bound for inference at
    RAGGED_BATCH under the pow2 bucket policy: a cold first call, then
    ``warmup`` and the first call after it, then batches of
    RAGGED_SIZES; each against an exact forward of that batch (an
    executor bound at its size), and no bind while the Module serves
    them."""
    free_card()
    saved = os.environ.get("MXTPU_SHAPE_BUCKETS")
    os.environ["MXTPU_SHAPE_BUCKETS"] = "pow2"
    gpu = mx.gpu(0)
    symbol = mx.sym.ZOO["resnet50_v1"]()
    gen = torch.Generator(device=gpu.torch_device).manual_seed(3)
    xs = {b: torch.rand((b, 3, 224, 224), generator=gen,
                        device=gpu.torch_device) for b in RAGGED_SIZES}

    def serving_module():
        mod = mx.mod.Module(symbol, data_names=("data0",),
                            label_names=("softmax_label",), context=gpu)
        mod.bind(data_shapes=[("data0", (RAGGED_BATCH, 3, 224, 224))],
                 label_shapes=[("softmax_label", (RAGGED_BATCH,))],
                 for_training=False)
        mod.init_params(arg_params=params, aux_params=aux)
        return mod

    def call(mod, b):
        t0 = time.perf_counter()
        mod.forward(mx.io.DataBatch([mx.nd.NDArray(xs[b])], None),
                    is_train=False)
        out = mod.get_outputs()[0]._data.clone()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    binds = []
    real_bind = mx.sym.Symbol.simple_bind

    def counted(self, *a, **kw):
        binds.append(kw.get("data0"))
        return real_bind(self, *a, **kw)

    try:
        _, cold_ms = call(serving_module(), RAGGED_BATCH)
        mod = serving_module()
        t0 = time.perf_counter()
        mod.warmup()
        torch.cuda.synchronize()
        warmup_ms = (time.perf_counter() - t0) * 1e3
        _, warm_ms = call(mod, RAGGED_BATCH)
        group = mod._exec_group
        mx.sym.Symbol.simple_bind = counted
        try:
            got = {b: call(mod, b) for b in RAGGED_SIZES}
            again = {b: call(mod, b)[1] for b in RAGGED_SIZES}
        finally:
            mx.sym.Symbol.simple_bind = real_bind
        errs = {}
        for b in RAGGED_SIZES:
            ex = symbol.simple_bind(ctx=gpu, grad_req="null",
                                    data0=(b, 3, 224, 224),
                                    softmax_label=(b,))
            ex.copy_params_from(params, aux)
            want = ex.forward(is_train=False,
                              data0=mx.nd.NDArray(xs[b]))[0]._data
            out = got[b][0]
            errs[b] = float((out.double() - want.double()).norm()
                            / want.double().norm()) \
                if out.shape == want.shape else float("inf")
            del ex
    finally:
        if saved is None:
            os.environ.pop("MXTPU_SHAPE_BUCKETS", None)
        else:
            os.environ["MXTPU_SHAPE_BUCKETS"] = saved
    row = dict(cold_ms=cold_ms, warmup_ms=warmup_ms, warm_ms=warm_ms,
               ms={b: got[b][1] for b in RAGGED_SIZES}, again_ms=again,
               rel=errs,
               binds=len(binds), rebound=mod._exec_group is not group)
    log("[a10c] %s: ragged_serve: ResNet-50 v1 bound for inference at "
        "batch %d, pow2 buckets (fp32, TF32 off): the first call of a "
        "module without warmup %.3f ms; warmup %.3f ms, then the first "
        "call %.3f ms (host clock, to the outputs on the card); batches "
        "%s: ms of the first call of each size (which pays two shape "
        "inferences of the graph for its padding mask) %s, of the second "
        "%s; against the exact forward (relative L2) %s (bound %g); "
        "binds while serving %d" % (
            card(), RAGGED_BATCH, cold_ms, warmup_ms, warm_ms,
            list(RAGGED_SIZES), ", ".join("%d: %.3f" % (b, v) for b, v
                                          in row["ms"].items()),
            ", ".join("%d: %.3f" % kv for kv in again.items()),
            ", ".join("%d: %.3g" % kv for kv in errs.items()), RAGGED_TOL,
            len(binds)))
    if binds or row["rebound"]:
        fail("a10c: the serving Module bound again (%s)" % binds)
    if not all(e <= RAGGED_TOL for e in errs.values()):
        fail("a10c: a ragged batch differs from its exact forward: %s"
             % errs)
    del mod, xs, got
    free_card()
    return row


def lenet(sym):
    """MXNet's LeNet (examples/image-classification/symbols/lenet.py)."""
    data = sym.Variable("data")
    c1 = sym.Convolution(data, kernel=(5, 5), num_filter=20, name="conv1")
    p1 = sym.Pooling(sym.Activation(c1, act_type="tanh"), pool_type="max",
                     kernel=(2, 2), stride=(2, 2))
    c2 = sym.Convolution(p1, kernel=(5, 5), num_filter=50, name="conv2")
    p2 = sym.Pooling(sym.Activation(c2, act_type="tanh"), pool_type="max",
                     kernel=(2, 2), stride=(2, 2))
    f1 = sym.FullyConnected(sym.Flatten(p2), num_hidden=500, name="fc1")
    f2 = sym.FullyConnected(sym.Activation(f1, act_type="tanh"),
                            num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(f2, name="softmax")


def synthetic_mnist(n, seed):
    """``n`` 28x28 images, each its class's fixed pattern plus noise."""
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 10, n)
    proto = np.random.RandomState(99).rand(10, 1, 28, 28)
    data = 0.7 * proto[label] + 0.3 * rng.rand(n, 1, 28, 28)
    return data.astype(np.float32), label.astype(np.float32)


def a10c_ctx_engine():
    """Row ctx_engine: the ``with`` scopes placing arrays, a gluon
    ``initialize()`` and a Module bind; cpu_pinned and cpu_shared
    arrays; the threaded engine built on this host and an error pushed
    on it raised at the wait; FeedForward fitting LeNet for an epoch on
    the card, its predict against Module's."""
    gpu, cpu = mx.gpu(0), mx.cpu()
    row = {}
    bad = []
    with gpu:
        a = mx.nd.zeros((2, 3))
        with cpu:
            b = mx.nd.ones((2, 3))
        c = mx.nd.array(np.arange(6, dtype=np.float32))
        net = mx.gluon.nn.Dense(4, in_units=3)
        net.initialize()
        fc = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=4,
                                   name="fc")
        mod = mx.mod.Module(fc, label_names=None)
        mod.bind(data_shapes=[("data", (2, 3))], for_training=False)
        mod.init_params()
    with cpu:
        net_cpu = mx.gluon.nn.Dense(4, in_units=3)
        net_cpu.initialize()
    placed = {"array": a.ctx, "nested cpu": b.ctx, "after nesting": c.ctx,
              "gluon": net.weight.data().ctx,
              "gluon under cpu": net_cpu.weight.data().ctx,
              "module": mod.get_params()[0]["fc_weight"].ctx,
              "no scope": mx.current_context()}
    want = {"array": gpu, "nested cpu": cpu, "after nesting": gpu,
            "gluon": gpu, "gluon under cpu": cpu, "module": gpu,
            "no scope": gpu}
    bad += ["%s on %s" % (k, v) for k, v in placed.items() if v != want[k]]
    if not (a._data.device == gpu.torch_device
            and b._data.device.type == "cpu"):
        bad.append("the tensors' devices")
    # page-locked and shared host arrays
    x = np.random.RandomState(0).rand(PIN_MB << 18).astype(np.float32)
    pinned = mx.nd.array(x, ctx=mx.cpu_pinned())
    plain = mx.nd.array(x, ctx=cpu)
    on_card = torch.empty(x.shape, device=gpu.torch_device)

    def copy_ms(src, non_blocking):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card.copy_(src._data, non_blocking=non_blocking)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    copy_ms(pinned, True)
    row["pinned_ms"] = min(copy_ms(pinned, True) for _ in range(3))
    row["pinned_equal"] = bool(torch.equal(on_card.cpu(), plain._data))
    row["pageable_ms"] = min(copy_ms(plain, False) for _ in range(3))
    if not (pinned._data.is_pinned() and pinned.ctx == mx.cpu_pinned()
            and row["pinned_equal"]):
        bad.append("cpu_pinned: pinned %s, ctx %s, copy equal %s" % (
            pinned._data.is_pinned(), pinned.ctx, row["pinned_equal"]))
    shared = mx.nd.array(x[:1024], ctx=mx.cpu_shared())
    if not (shared._data.is_shared() and shared.ctx == mx.cpu_shared()
            and np.array_equal(shared.copyto(gpu).asnumpy(), x[:1024])):
        bad.append("cpu_shared")
    del pinned, plain, on_card, shared
    # the engine: built here (once more into a temporary directory, to
    # time g++ on this host), an error raised at the wait
    lib = mx.engine.get_lib()
    tmp = tempfile.mkdtemp(prefix="a10c_engine_")
    t0 = time.monotonic()
    mx.engine.build(tmp)
    row["engine_build_s"] = time.monotonic() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    eng = mx.engine.get_engine()
    var = eng.new_var()

    def boom():
        raise ValueError("raised on a worker thread")

    eng.push(boom, mutable_vars=[var])
    try:
        eng.wait_for_var(var)
        row["error_at_wait"] = None
    except mx.MXNetError as e:
        row["error_at_wait"] = str(e)
    if not isinstance(eng, mx.engine.ThreadedEngine) or \
            "raised on a worker thread" not in (row["error_at_wait"] or ""):
        bad.append("the engine: %s, error at the wait %r"
                   % (type(eng).__name__, row["error_at_wait"]))
    # FeedForward: LeNet for an epoch on the card
    xtr, ytr = synthetic_mnist(LENET_TRAIN, 1)
    xte, yte = synthetic_mnist(LENET_TEST, 2)
    symbol = lenet(mx.sym)
    mx.random.seed(0)
    ff = mx.model.FeedForward(symbol, ctx=gpu, num_epoch=1,
                              optimizer="sgd",
                              initializer=mx.initializer.Xavier())
    t0 = time.monotonic()
    ff.fit(mx.io.NDArrayIter(xtr, ytr, batch_size=LENET_BATCH, ctx=gpu),
           optimizer_params={"learning_rate": 0.1})
    row["fit_s"] = time.monotonic() - t0
    test = mx.io.NDArrayIter(xte, yte, batch_size=LENET_BATCH, ctx=gpu)
    pred = ff.predict(test)
    row["accuracy"] = ff.score(test)
    lmod = mx.mod.Module(symbol, context=gpu)
    lmod.bind(data_shapes=test.provide_data,
              label_shapes=test.provide_label, for_training=False)
    lmod.set_params(ff.arg_params, ff.aux_params)
    mpred = lmod.predict(test).asnumpy()
    row["predict_rel"] = float(np.linalg.norm(pred - mpred)
                               / np.linalg.norm(mpred))
    row["predict_bitwise"] = bool(np.array_equal(pred, mpred))
    row["bad"] = bad
    log("[a10c] %s: ctx_engine: placed by the scopes %s; a %d MB host "
        "array to the card: pinned, non_blocking %.3f ms (%.2f GB/s, "
        "equal %s), pageable %.3f ms (%.2f GB/s); the engine built from "
        "src/engine.cc in %.1f s (%s), %s, an error pushed on it raised "
        "at the wait: %r; FeedForward LeNet, one epoch of %d synthetic "
        "MNIST images at batch %d on the card in %.1f s, accuracy %.4f on "
        "%d more; its predict against Module's: relative L2 %.3g, bitwise "
        "%s" % (card(), {k: str(v) for k, v in placed.items()}, PIN_MB,
                row["pinned_ms"], x.nbytes / row["pinned_ms"] / 1e6,
                row["pinned_equal"], row["pageable_ms"],
                x.nbytes / row["pageable_ms"] / 1e6, row["engine_build_s"],
                lib._name, type(eng).__name__, row["error_at_wait"],
                LENET_TRAIN, LENET_BATCH, row["fit_s"], row["accuracy"],
                LENET_TEST, row["predict_rel"], row["predict_bitwise"]))
    if not row["predict_rel"] <= 1e-6:
        bad.append("FeedForward's predict differs from Module's by %.3g"
                   % row["predict_rel"])
    if bad:
        fail("a10c: ctx_engine: %s" % "; ".join(bad))
    return row


def phase_a10c():
    """A10c's leftovers on the card: the rows ctx_engine,
    imagenet_monitor, resnet50_nhwc_fp32, resnet50_nhwc_bf16 (with the
    step check) and ragged_serve; returns the rows."""
    t0 = time.monotonic()
    rows = {}
    zero_launches()
    rows["ctx_engine"] = a10c_ctx_engine()
    rows["ctx_engine"]["launches"] = read_launches()
    zero_launches()
    rows["imagenet_monitor"] = a10c_imagenet_monitor()
    rows["imagenet_monitor"]["launches"] = read_launches()
    params, aux = resnet_weights()
    rows.update(a10c_nhwc_rows(params, aux))
    zero_launches()
    rows["ragged_serve"] = a10c_ragged_serve(params, aux)
    rows["ragged_serve"]["launches"] = read_launches()
    for name, r in rows.items():
        if any(r["launches"].values()):
            fail("a10c: %s launched a flash-attention kernel: %s"
                 % (name, r["launches"]))
    log("[a10c] %s: flash-attention launches by row %s; the phase took "
        "%.1f s" % (card(), {k: r["launches"] for k, r in rows.items()},
                    time.monotonic() - t0))
    del params, aux
    free_card()
    return rows


SPMD_RING = (8, 8, 1024, 128)    # global (B, H, T, D) of the ring check
SPMD_RING_SP = (2, 4)
RING_TOL = dict(rtol=0.05, atol=0.05)   # tests/test_pallas_attention.py, bf16
SPMD_AXES = {"dp": 2, "pp": 2, "tp": 2, "sp": 2}
SPMD_BATCH, SPMD_MICRO, SPMD_STEPS, SPMD_LR = 8, 2, 3, 1e-3
SPMD_LM_DEVICES = 8
SPMD_DEVICE = torch.device("cuda", 0)   # the card every shard is on
# the sharded step against the one-device step (bf16): the loss, the
# first moments' relative L2 (0.1 * the gradient), the share of
# parameters more than a bf16 ulp of each side apart (measured on the
# CPU at a narrow width: 6.3e-4, 0.015, 0.9%;
# tests/test_torch_spmd_step_c.py)
SPMD_LOSS_TOL, SPMD_MOMENT_TOL, SPMD_MOVED_SHARE = 0.01, 0.03, 0.05


def spmd_launches(cfg, mesh, n_micro):
    """Kernel launches a sharded step makes: per microbatch, layer and
    (dp, tp, ep) group, sp(sp+1)/2 causal ring blocks, each one launch
    of each backward kernel and of the forward, twice under a remat
    policy that recomputes it ("dots": the policy never sees the ctypes
    launch)."""
    sp = mesh.shape["sp"]
    blocks = n_micro * cfg.n_layers * (mesh.size // sp // mesh.shape["pp"]) \
        * sp * (sp + 1) // 2
    return {"flash_fwd": blocks * (2 if cfg.remat != "none" else 1),
            "flash_bwd_dq": blocks, "flash_bwd_dkv": blocks}


def ring_errors(got, ref):
    """Each tensor's errors against ``ref``: the largest, its share of
    ``RING_TOL``'s bound, the relative L2; and whether all keep to the
    bounds."""
    errs = []
    for a, b in zip(got, ref):
        d = (a.float() - b.float())
        errs.append(dict(
            max_abs_err=d.abs().max().item(),
            err_over_tol=(d.abs() / (RING_TOL["atol"] + RING_TOL["rtol"]
                                     * b.float().abs())).max().item(),
            rel_l2=(d.norm() / b.float().norm()).item()))
    ok = all(e["err_over_tol"] <= 1.0 and e["rel_l2"] <= BF16_REL_L2
             for e in errs)
    return errs, ok


def spmd_ring_check():
    """The ring over ``[cuda:0] * sp`` at the global ``SPMD_RING``
    shape, bf16, causal and not: the kernels against the plain ring and
    the unsharded kernels; launches exact.  Returns the rows."""
    import importlib

    tra = importlib.import_module("mxtpu_torch.parallel.ring_attention")
    gen = torch.Generator(device=SPMD_DEVICE).manual_seed(19)
    D = SPMD_RING[3]
    q, k, v, g = (torch.randn(SPMD_RING, device=SPMD_DEVICE, generator=gen)
                  .to(torch.bfloat16) for _ in range(4))
    scale = D ** -0.5
    rows = {}
    for sp in SPMD_RING_SP:
        for causal in (True, False):
            name = "spmd_ring_sp%d_%s" % (sp, "causal" if causal else "full")
            whole = [t.clone().requires_grad_(True) for t in (q, k, v)]

            def unsharded():
                o = fa.flash_attention(*whole, causal=causal)
                return [o] + list(torch.autograd.grad(o, whole, g))

            def chunks(t, grad=True):
                return [c.contiguous().requires_grad_(grad)
                        for c in t.chunk(sp, 2)]

            qs, ks, vs = chunks(q), chunks(k), chunks(v)
            gs = chunks(g, False)

            def ring():
                outs = tra.ring_attention(qs, ks, vs, causal=causal)
                grads = torch.autograd.grad(outs, qs + ks + vs, gs)
                return [torch.cat(outs, 2)] + [
                    torch.cat(grads[i * sp:(i + 1) * sp], 2)
                    for i in range(3)]

            def plain():
                c = [[x.detach() for x in xs] for xs in (qs, ks, vs)]
                outs, lses = tra._ring_forward_plain(*c, causal, scale)
                grads = tra._ring_backward_plain(*c, outs, lses, gs, causal,
                                                 scale)
                return [torch.cat(outs, 2)] + [torch.cat(x, 2)
                                               for x in grads]

            ref = unsharded()
            zero_launches()
            got = ring()
            torch.cuda.synchronize()
            launches = read_launches()
            want = sp * (sp + 1) // 2 if causal else sp * sp
            if launches != {n: want for n in KERNELS}:
                fail("spmd: %s launched %s, want %d of each"
                     % (name, launches, want))
            vs_plain, ok_plain = ring_errors(got, plain())
            vs_whole, ok_whole = ring_errors(got, ref)
            rows[name] = dict(
                shape=list(SPMD_RING), sp=sp, causal=causal,
                against_plain_ring=dict(zip(("o", "dq", "dk", "dv"),
                                            vs_plain)),
                against_unsharded=dict(zip(("o", "dq", "dk", "dv"),
                                           vs_whole)),
                ms=time_ms(ring, 3), plain_ms=time_ms(plain, 2),
                unsharded_ms=time_ms(unsharded, 3),
                launches=launches)
            log("[spmd] " + json.dumps(rows[name]))
            if not (ok_plain and ok_whole):
                fail("spmd: the ring's kernels disagree: %s" % rows[name])
    return rows


QUEUED_TRIES = 3


def queued_ms(fn, iters):
    """The card's time per call of fn without the profiler: CUDA events
    around ``iters`` calls queued behind a sleep kernel, so that the
    card runs them back to back whatever the host's speed.  Gaps could
    only lengthen it; (ms, whether the host had queued every call before
    the sleep ended)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(int(4e9 * host_s) + 100000)  # about 2x host_s
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued_s = time.perf_counter() - t0
    ev[2].record()
    torch.cuda.synchronize()
    return (ev[1].elapsed_time(ev[2]) / iters,
            queued_s * 1e3 < ev[0].elapsed_time(ev[1]))


def checked_queued_ms(fn, iters, bound):
    """queued_ms of fn, measured again while a reading is at or under
    the call's bound or the host fell behind the queue; (the first
    valid reading or None, the refused readings).  The profiler's
    readings of these small calls late in this script came out at a
    third to a sixth of their times alone (runs 19.2, 19.5), so this
    row does not use it."""
    refused = []
    for _ in range(QUEUED_TRIES):
        t, held = queued_ms(fn, iters)
        if held and t > bound:
            return t, refused
        refused.append(t)
    return None, refused


def spmd_blocks(cfg, mesh, batch, n_micro):
    """Each kernel's device time at the sharded step's ring block,
    (mb * H / tp, T / sp, D) bf16 (``checked_queued_ms``): the forward
    with the LSE (causal, as on the diagonal), dq and dk/dv (causal),
    beside their bounds and plain versions; SDPA's forward on the same
    block for the forward, and SDPA's backward (forward and backward
    minus forward, the main rows' convention) for the pair.  A refused
    reading is printed as None beside the refused values."""
    mb = batch // mesh.shape["dp"] // n_micro
    bh = mb * cfg.n_heads // mesh.shape["tp"]
    t = cfg.max_len // mesh.shape["sp"]
    d = cfg.d_model // cfg.n_heads
    gen = torch.Generator(device=SPMD_DEVICE).manual_seed(23)
    q, k, v, g = (torch.randn(bh, t, d, device=SPMD_DEVICE, generator=gen)
                  .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    out, lse = fa._flash_forward_cuda(q, k, v, scale, True, True)
    launches = backward_launches(q, k, v, g, out, lse, scale, True)
    launches["flash_fwd"] = lambda: fa._flash_forward_cuda(
        q, k, v, scale, True, True)
    plain = {"flash_fwd": lambda: fa._reference_attention_lse(
        q, k, v, scale, True)}
    plain["flash_bwd_dq"] = plain["flash_bwd_dkv"] = \
        lambda: fa._flash_bwd_reference(q, k, v, g, out, lse, scale, True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x.detach().view(1, bh, t, d).requires_grad_(True)
                  for x in (q, k, v))
    fwd_bound = attention_bound_ms(bh, t, t, d, q.dtype, True, True)[0]
    lib = {"fwd": lambda: sdpa(q4, k4, v4, is_causal=True),
           "both": lambda: torch.autograd.grad(
               sdpa(q4, k4, v4, is_causal=True), (q4, k4, v4),
               g.view(1, bh, t, d))}
    lib_ms, lib_refused = {}, {}
    for key, fn in lib.items():
        # the forward's bound holds for both calls
        lib_ms[key], lib_refused[key] = checked_queued_ms(fn, 50, fwd_bound)
    sdpa_bwd = None if None in lib_ms.values() else \
        lib_ms["both"] - lib_ms["fwd"]
    blocks = {}
    for name, launch in launches.items():
        bound, by = (attention_bound_ms(bh, t, t, d, q.dtype, True, True)
                     if name == "flash_fwd" else
                     backward_bound_ms(name, bh, t, t, d, q.dtype, True))
        dev, refused = checked_queued_ms(launch, 50, bound)
        blocks[name] = dict(
            shape="(%d,%d,%d)" % (bh, t, d), causal=True,
            device_ms=dev, device_ms_refused=refused, ms=time_ms(launch, 50),
            plain_ms=time_ms(plain[name], 5), bound_ms=bound, bound_by=by,
            library_ms=lib_ms["fwd"] if name == "flash_fwd" else sdpa_bwd,
            library_refused=lib_refused)
    return blocks


def spmd_step_check(cfg, one, one_opt, one_loss, params, opt, loss):
    """Step 1 on the mesh against the one-device step from the same
    weights: the loss, each first moment (relative L2), each parameter
    (within 2 lr and a bf16 ulp of each side; the share further apart);
    returns the readings."""
    d_loss = abs(loss.item() - one_loss.item())
    moments, moved, worst = {}, {}, 0.0
    for n, t in one.items():
        m1 = one_opt["m"][n]
        m2 = spmd.gather(opt["m"][n]).reshape(m1.shape)
        moments[n] = ((m2 - m1).norm() / m1.norm()).item()
        a, b = spmd.gather(params[n]).reshape(t.shape).float(), t.float()
        diff = (a - b).abs()
        ulp = (a.abs() + b.abs()) * 2 ** -7 + 1e-6
        worst = max(worst, (diff - 2 * SPMD_LR - ulp).max().item())
        moved[n] = (diff > ulp).float().mean().item()
    out = dict(loss=loss.item(), one_device_loss=one_loss.item(),
               d_loss=d_loss, moment_rel_l2=moments,
               share_beyond_ulp=moved, worst_excess=worst)
    log("[spmd] step 1 on the mesh against the one-device step: "
        + json.dumps(out))
    if not (d_loss <= SPMD_LOSS_TOL and worst <= 0.0
            and max(moments.values()) <= SPMD_MOMENT_TOL
            and max(moved.values()) <= SPMD_MOVED_SHARE):
        fail("spmd: the sharded step disagrees with the one-device step")
    return out


def spmd_moment_memory(cfg, mesh, opt):
    """Each device's moment bytes: 1/dp of its parameter shard's moments
    where ZeRO-1 splits them, all of them elsewhere."""
    dp, zdims = mesh.shape["dp"], tf._zero1_dims(cfg, mesh)
    specs = tf.param_specs(cfg)
    per_device = []
    for c in range(mesh.size):
        held = whole = 0
        for key in ("m", "v"):
            for n, s in opt[key].items():
                local = int(np.prod([x.stop - x.start for x in spmd._blocks(
                    mesh, specs[n], s.shape)[c]])) * 4
                whole += local
                held += s.device_nbytes()[c]
                want = local // dp if zdims[n] is not None else local
                if s.device_nbytes()[c] != want:
                    fail("spmd: %s %s holds %d bytes at %s, want %d"
                         % (key, n, s.device_nbytes()[c], mesh.coords[c],
                            want))
        per_device.append((held, whole))
    held, whole = per_device[0]
    log("[spmd] moments a device: %.1f MB of its shard's %.1f MB (%.3f; "
        "dp %d; every device alike: %s)"
        % (held / 1e6, whole / 1e6, held / whole, dp,
           len(set(per_device)) == 1))
    return dict(moment_bytes=held, shard_moment_bytes=whole)


def spmd_model_step():
    """The full-width model on 16 shards of this card: step 1 against
    the one-device step, then steps 2 and 3 timed and profiled."""
    from mxtpu_torch.parallel import mesh as pmesh

    cfg = tf.TransformerConfig(remat="dots", **MODEL)
    mesh = pmesh.create_mesh(SPMD_AXES, devices=[SPMD_DEVICE] * int(
        np.prod(list(SPMD_AXES.values()))))
    rng = np.random.RandomState(19)
    tok = rng.randint(0, cfg.vocab, (SPMD_BATCH, cfg.max_len)).astype(
        np.int32)
    lab = rng.randint(0, cfg.vocab, (SPMD_BATCH, cfg.max_len)).astype(
        np.int32)
    base = tf.init_params(cfg, SPMD_DEVICE, seed=0)
    params = tf.shard_params(base, cfg, mesh)
    opt = tf.init_opt_state(cfg, mesh)
    one_step, _ = tf.make_train_step(cfg, SPMD_DEVICE, n_micro=SPMD_MICRO,
                                     lr=SPMD_LR, optimizer="adam")
    one, one_opt, one_loss = one_step(
        base, tf.init_opt_state(cfg, SPMD_DEVICE), tok, lab)
    step, info = tf.make_train_step(cfg, mesh, n_micro=SPMD_MICRO,
                                    lr=SPMD_LR, optimizer="adam")
    data = [spmd.device_put(x, info["data"]) for x in (tok, lab)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = spmd_launches(cfg, mesh, SPMD_MICRO)
    losses, walls, launches = [], [], []
    for i in range(SPMD_STEPS):
        zero_launches()
        t0 = time.monotonic()
        if i == SPMD_STEPS - 1:
            done = []
            spans = device_spans(lambda: done.append(
                step(params, opt, *data)), tries=1)
            if len(done) != 1 or not spans:
                fail("spmd: the profiler saw no device time in a step")
            params, opt, loss = done[0]
        else:
            params, opt, loss = step(params, opt, *data)
        losses.append(loss.item())   # a value fetch: synchronised
        walls.append((time.monotonic() - t0) * 1e3)
        launches.append(read_launches())
        if i == 0:
            check = spmd_step_check(cfg, one, one_opt, one_loss, params,
                                    opt, loss)
            del one, one_opt
    peak = torch.cuda.max_memory_allocated()
    memory = spmd_moment_memory(cfg, mesh, opt)
    busy, window, heads = profile_summary(spans)
    row = dict(mesh=SPMD_AXES, shards=mesh.size, batch=SPMD_BATCH,
               n_micro=SPMD_MICRO, losses=losses, wall_ms=walls,
               busy_ms=busy, window_ms=window, idle=1 - busy / window,
               device_ops=len(spans), peak_bytes=peak, launches=launches[-1],
               launches_by_step=launches, want_launches=want, check=check,
               blocks=spmd_blocks(cfg, mesh, SPMD_BATCH, SPMD_MICRO),
               **memory)
    log("[spmd] %s: the 16-shard step (%s, batch %d, n_micro %d, ZeRO-1 "
        "Adam): losses %s; wall ms a step %s (step 3 under the profiler); "
        "step 3 device busy %.3f ms in a %.3f ms window (idle share at "
        "most %.3f), %d device operations; peak %.1f MB; launches a step "
        "%s; most device time: %s"
        % (card(), SPMD_AXES, SPMD_BATCH, SPMD_MICRO,
           " ".join("%.4f" % x for x in losses),
           " ".join("%.1f" % x for x in walls), busy, window, row["idle"],
           len(spans), peak / 1e6, launches[-1],
           "; ".join("%s %.3f ms" % (n[:50], t / 1e3) for n, t in heads)))
    log("[spmd] kernels at the ring's block: " + json.dumps(row["blocks"]))
    if any(x != want for x in launches):
        fail("spmd: launches a step %s, want %s" % (launches, want))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("spmd: losses not finite or not falling: %s" % losses)
    return row


def spmd_transformer_lm():
    """examples/transformer_lm/train.py at its defaults over
    ``[cuda:0] * 8``: it must print CONVERGED."""
    ep = tests_module("test_torch_example_port")
    out = io.StringIO()
    zero_launches()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        ep.run_transformer_lm([], [SPMD_DEVICE] * SPMD_LM_DEVICES)
    secs = time.monotonic() - t0
    lines = out.getvalue().splitlines()
    row = dict(seconds=secs, last_lines=lines[-3:],
               launches=read_launches())
    log("[spmd] transformer_lm on [cuda:0] * %d: %.1f s, %s, launches %s"
        % (SPMD_LM_DEVICES, secs, " | ".join(lines[-3:]), row["launches"]))
    if not lines or lines[-1] != "CONVERGED":
        fail("spmd: transformer_lm did not converge: %s" % lines[-5:])
    if not all(row["launches"].values()):
        fail("spmd: transformer_lm launched %s" % row["launches"])
    return row


def spmd_microbench():
    """``parallel.collectives.microbench`` over {dp 2, tp 4} on
    ``[cuda:0] * 8``: every collective checked; its rates are of
    same-device copies, which it says."""
    from mxtpu_torch.parallel import collectives, mesh as pmesh

    mesh = pmesh.create_mesh({"dp": 2, "tp": 4},
                             devices=[SPMD_DEVICE] * 8)
    zero_launches()
    res = collectives.microbench(mesh, n_bytes=1 << 24, reps=5)
    row = dict(results=res, launches=read_launches())
    log("[spmd] collectives.microbench, 16 MB over {dp 2, tp 4} on one "
        "card (same-device copies): " + json.dumps(res))
    if not all(r["ok"] for a in res.values() for r in a.values()):
        fail("spmd: a collective's result is wrong: %s" % res)
    return row


def phase_spmd():
    """The SPMD half on one card: the ring rows, the 16-shard step, the
    collectives' microbench and the example; returns the rows."""
    t0 = time.monotonic()
    rows = spmd_ring_check()
    rows["spmd_microbench"] = spmd_microbench()
    rows["spmd_step"] = spmd_model_step()
    free_card()
    rows["spmd_transformer_lm"] = spmd_transformer_lm()
    log("[spmd] %s: launches by row %s; the phase took %.1f s; one card "
        "holds every shard, so no interconnect is measured"
        % (card(), {k: r["launches"] for k, r in rows.items()},
           time.monotonic() - t0))
    return rows


# a process of the --parent comparison: the sparse and lm phases of the
# checkout in its working directory, their rows printed as JSON
PARENT_CODE = ("import json, sys; sys.argv = ['chip_smoke.py']; "
               "import chip_smoke as c; r = c.phase_sparse(); "
               "r.update(c.phase_lm()); "
               "print('PHASE_ROWS ' + json.dumps(r, default=str), "
               "flush=True)")


def phase_parent(parent):
    """The sparse and lm phases of the checkout ``parent`` against this
    one's, in turns (parent, this, this, parent), each run in a process
    of its own: each row's ms, busy ms, device operations and syncs."""
    runs = []
    for label, root in (("parent", Path(parent).resolve()),
                        ("this", REPO_ROOT), ("this", REPO_ROOT),
                        ("parent", Path(parent).resolve())):
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable, "-c", PARENT_CODE],
                              cwd=str(root), env=dict(
                                  os.environ, PYTHONPATH=str(root)),
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            fail("--parent: the %s run in %s exited %d: %s"
                 % (label, root, proc.returncode,
                    (proc.stdout + proc.stderr)[-3000:]))
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("PHASE_ROWS ")][-1]
        runs.append((label, json.loads(line[len("PHASE_ROWS "):])))
        log("[parent] the %s run (%s) took %.1f s"
            % (label, root, time.monotonic() - t0))
    for row in runs[0][1]:
        for key in ("ms", "busy_ms", "ops", "syncs"):
            if key in runs[0][1][row]:
                log("[parent] %s %s, in turns: %s" % (row, key, ", ".join(
                    "%s %s" % (label, r[row][key]) for label, r in runs)))


def parse_args():
    ap = argparse.ArgumentParser(
        description="Chip smoke test of mxtpu_torch on one H100; with no "
        "arguments, every phase.")
    ap.add_argument("--baseline", metavar="DIR",
                    help="also time the kernels of the checkout DIR "
                    "against this one's, in turns, on device time")
    ap.add_argument("--fault-run", action="store_true",
                    help="build and the fault run only: the forward and "
                    "backward checks on the committed kernels and on "
                    "mutated copies, then the fused check on the loop "
                    "and on copies with planted faults")
    ap.add_argument("--ablate", action="store_true",
                    help="build and the ablations only: the kernels "
                    "against copies with a part taken out, on device time")
    ap.add_argument("--parent", metavar="DIR",
                    help="only the sparse and lm phases of the checkout "
                    "DIR against this one's, in turns, each in a process "
                    "of its own")
    ap.add_argument("--dist-worker", choices=["dist_async", "dist_sync"],
                    help="a worker of the dist phase's launch (run by "
                    "the launcher, not by hand)")
    ap.add_argument("--mnist-worker", metavar="KVSTORE",
                    help="a worker of the mnist phase's launch")
    ap.add_argument("--out", metavar="DIR",
                    help="where a worker writes its results")
    return ap.parse_args()


def main():
    args = parse_args()
    if args.dist_worker:
        dist_worker(args.dist_worker, args.out)
        return
    if args.mnist_worker:
        mnist_worker(args.mnist_worker, args.out)
        return
    name_limit = card()
    log("[card] %s" % name_limit)
    if args.parent:
        phase_parent(args.parent)
        return
    phase_build()
    if args.fault_run:
        phase_fault_run()
        fused_check(faults=True)
        return
    if args.ablate:
        phase_ablate()
        return
    records = phase_kernel()
    if args.baseline:
        phase_baseline(args.baseline)
    served = phase_serve()
    trained = phase_train(records)
    resnet = phase_resnet()
    fused = phase_fused()
    gluon = phase_gluon(resnet)
    lm = phase_lm()
    sparse = phase_sparse()
    dist = phase_dist()
    mnist = phase_mnist()
    phase_ops()
    zoo = phase_zoo()
    imagenet = phase_imagenet()
    optim = phase_optim()
    rand = phase_random()
    gan = phase_gan()
    seq = phase_seq()
    cflow = phase_cflow()
    data = phase_data()
    det = phase_det()
    quant = phase_quant()
    a10c = phase_a10c()
    spmd_rows = phase_spmd()
    sources = {"flash_fwd": ("flash_fwd.cu", 149),
               "flash_bwd_dq": ("flash_bwd.cu", 277),
               "flash_bwd_dkv": ("flash_bwd.cu", 309)}
    kernels = []
    for name, (src, line) in sources.items():
        rec = records[name]
        by_path = {"serve": served if name == "flash_fwd" else 0,
                   "train": trained[name],
                   "resnet": resnet["launches"][name]}
        by_path.update({row: r["launches"][name]
                        for row, r in fused.items()})
        by_path.update({row: r["launches"][name]
                        for row, r in gluon.items()})
        by_path.update({row: r["launches"][name] for row, r in lm.items()})
        by_path.update({row: r["launches"][name]
                        for row, r in sparse.items()})
        by_path.update({row: r["launches"][name]
                        for row, r in dist.items()})
        by_path.update({row: r["launches"][name]
                        for row, r in mnist.items()})
        by_path.update({row: r["launches"][name]
                        for rows in (zoo, imagenet, optim, rand, gan, seq,
                                     cflow, data, det, quant, a10c,
                                     spmd_rows)
                        for row, r in rows.items()})
        kernels.append(dict(
            name=name, route="cuda",
            source="mxtpu_torch/ops/csrc/" + src,
            replaces="mxtpu/ops/pallas_attention.py:%d" % line,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            device_ms=rec["device_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"],
            ring_block=spmd_rows["spmd_step"]["blocks"][name]))
    log(json.dumps({"kernels": kernels}))
    log(name_limit)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
