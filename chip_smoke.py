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

The line before the last is the card's name and power limit, the line
before that the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero and prints no result.

Options (none by default): ``--baseline DIR`` also builds the kernels
of the checkout DIR (such as the parent commit unpacked by ``git
archive``) and times each (the forward with and without the LSE, dq,
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
import dataclasses
import json
import logging
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

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
from mxtpu_torch.ops import flash_attention as fa  # noqa: E402
from mxtpu_torch.ops import kernel_build as kb  # noqa: E402
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
                cfg, x, lw["wq"], lw["wk"], lw["wv"], lw["wo"])),
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
    params = tf.init_params(cfg, device="cuda", seed=0)
    log("[serve] %d parameters, %s" % (
        sum(p.numel() for p in params.values()), cfg))
    fwd = tf.make_forward(cfg, device="cuda")
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
    ref = tf.make_forward(cpu_cfg, device="cpu")(cpu_params, x)[:, -1]
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


def step_breakdown(cfg, params, opt, tok, lab):
    """Device time (CUDA events) of one step's forward and loss, its
    backward and its Adam update, the parts of the port's step; the
    second of two runs."""
    loss_fn = tf._build_loss_fn(cfg, 1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(2):
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        ev[0].record()
        loss = loss_fn(leaves, tok, lab)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        ev[2].record()
        tf._update(params, opt, dict(zip(leaves, grads)), "adam", 1e-3)
        ev[3].record()
        torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def step_profile(cfg, params, opt, tok, lab, top=8):
    """One step under torch.profiler: the device's busy time (the union
    of its kernels' intervals), the step's window from the first kernel
    to the last, and the kernels with the most device time.  The
    profiler's own host work widens the window, so the idle share it
    gives is an upper bound."""
    def step():
        _, grads = tf._loss_and_grads(cfg, 1)(params, tok, lab)
        tf._update(params, opt, grads, "adam", 1e-3)

    spans = device_spans(step)
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
    params = tf.init_params(small, device="cuda", seed=0)
    tok, lab = tokens[:1], labels[:1]
    t0 = time.monotonic()
    loss, grads = tf._loss_and_grads(small, 1)(
        params, torch.from_numpy(tok).cuda().long(),
        torch.from_numpy(lab).cuda().long())
    ref_cfg = dataclasses.replace(small, dtype="float32", remat="none")
    ref_loss, ref_grads = tf._loss_and_grads(ref_cfg, 1)(
        {k: v.float().cpu() for k, v in params.items()},
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
    params = tf.init_params(cfg, device="cuda", seed=0)
    opt = tf.init_opt_state(cfg, device="cuda")
    step, _ = tf.make_fused_train_steps(cfg, K_STEPS, device="cuda",
                                        lr=1e-3, optimizer="adam")
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


def resnet_step_check(params, aux):
    """One SGD step at batch 2 on the card (TF32 off) against the same
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

    def step(ctx):
        mod = resnet_module(2, ctx)
        mod.init_params(arg_params=params, aux_params=aux)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.01, "momentum": 0.9})
        batch = resnet_batch(2, ctx, seed=1)
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        arg, _ = mod.get_params()
        return (mod.get_outputs()[0].asnumpy().astype(np.float64),
                {k: arg[k].asnumpy().astype(np.float64) - params[k]
                 for k in names})

    def exact_step():
        """The first SGD step in float64 on the CPU: the update is
        -lr * rescale * grad (the momentum starts at zero, wd 0)."""
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
                {k: -0.01 / 2 * ex.grad_dict[k].asnumpy() for k in names})

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
    log("[resnet] one step at batch 2, CPU float32 vs float64: output "
        "%.3g, all updates %.3g (relative L2)"
        % (np.linalg.norm(cpu_out - ex_out) / np.linalg.norm(ex_out),
           cpu_all / all_norm))
    verdict = {}
    for name, (out, upd) in runs.items():
        per, total = err(upd, ex_upd)
        ratio = {k: per[k] / allowed[k] for k in names}
        worst = max(ratio, key=ratio.get)
        out_rel = float(np.linalg.norm(out - cpu_out)
                        / np.linalg.norm(cpu_out))
        verdict[name] = (out_rel, ratio[worst],
                         total / (2 * cpu_all + 1e-3 * all_norm))
        log("[resnet] one step at batch 2, card (%s): output vs CPU %.3g "
            "(relative L2, bound %g); vs float64 all updates %.3g "
            "(relative L2), %.3g of its bound; worst parameter %s at %.3g "
            "of its bound (its update %.3g off, the CPU's %.3g)"
            % (name, out_rel, RESNET_OUT_TOL, total / all_norm,
               verdict[name][2], worst, ratio[worst],
               per[worst] / max(norm[worst], 1e-300),
               cpu_per[worst] / max(norm[worst], 1e-300)))
    log("[resnet] the step checks took %.1f s" % (time.monotonic() - t0))
    out_rel, worst, total = verdict["TF32 off"]
    if not (out_rel <= RESNET_OUT_TOL and worst <= 1 and total <= 1):
        fail("resnet: the card's step disagrees with the CPU step")


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
    """ROADMAP C4: raw nd.Convolution at ResNet's first layer, and raw
    nd.FullyConnected and nd.RNN at the word LM's shapes, called after
    the process set both TF32 flags on, each against the same op in
    float64 within C4_TOL; the same calls with the ops' TF32 rule
    taken out must fail it."""
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
    return ap.parse_args()


def main():
    args = parse_args()
    name_limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("[card] %s" % name_limit)
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
        kernels.append(dict(
            name=name, route="cuda",
            source="mxtpu_torch/ops/csrc/" + src,
            replaces="mxtpu/ops/pallas_attention.py:%d" % line,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            device_ms=rec["device_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"]))
    log(json.dumps({"kernels": kernels}))
    log(name_limit)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
