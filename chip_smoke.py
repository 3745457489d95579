"""Chip smoke test of the PyTorch port (``mxtpu_torch``) on one NVIDIA H100.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. build   -- compile the flash-attention forward kernel
   (``mxtpu_torch/ops/csrc/flash_fwd.cu``) with nvcc for sm_90a.
2. kernel  -- hold the kernel against its plain PyTorch version on the
   card at the served shape (64, 1024, 128) bf16 causal, and in f32 and
   bf16 at (6, 384, 64) causal and not, at the ragged (2, 100, 32) x
   (2, 90, 32) causal and not, and at (3, 130, 16) causal, each with
   and without the LSE.  Tolerances: f32 rtol 2e-4 / atol 2e-5, the
   bounds tests/test_pallas_attention.py holds the TPU kernel to; bf16
   one ulp of a probability plus one of the output, atol 2e-3 / rtol
   2^-6 of ``error_scale``, a relative L2 error of at most 1e-2, and
   that file's 0.05 (alone too loose: a typical output at the served
   shape is about that size).  Prints the kernel's and the plain
   version's times, the least time the card could take (bound), and
   ``torch.nn.functional.scaled_dot_product_attention`` at the served
   shape as a yardstick the port never calls.
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
   forward's device time by bucket and by block.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero and prints no result.
"""
import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -6, atol=2e-3)}
BF16_REL_L2 = 1e-2
SERVED = (64, 1024, 128)   # (batch*heads, T, head_dim) at batch 8
CLIENTS, PER_CLIENT = 8, 150

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py: no CUDA device is present\n")
    sys.exit(2)

from mxtpu_torch import serve  # noqa: E402
from mxtpu_torch.ops import flash_attention as fa  # noqa: E402
from mxtpu_torch.parallel import transformer as tf  # noqa: E402


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


def attention_bound_ms(bh, tq, tk, d, dtype, causal, want_lse):
    """Least time for the function on these inputs: q, k, v read once,
    o (and lse) written once, over the memory rate; 4*d flops per
    (query, key) pair the mask keeps, over the peak rate of the type."""
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * bh * tq * d + 2 * bh * tk * d) * esz
    nbytes += bh * tq * 4 if want_lse else 0
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    flops = 4.0 * d * bh * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def phase_build():
    t0 = time.monotonic()
    fa.FLASH_FWD.load()
    log("[build] flash_fwd.cu built and loaded in %.2f s"
        % (time.monotonic() - t0))
    for line in fa.FLASH_FWD.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("[build]   " + line.strip())


def phase_kernel():
    """Kernel vs plain on the card; returns the served shape's record."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the served shape, then each path (f32 on the CUDA cores, bf16 on
    # the tensor cores) at smaller head dims and ragged lengths
    cases = [(SERVED, 1024, torch.bfloat16, True)] + [
        (shape, tk, dtype, causal)
        for dtype in (torch.float32, torch.bfloat16)
        for shape, tk, causals in (((6, 384, 64), 384, (False, True)),
                                   ((2, 100, 32), 90, (False, True)),
                                   ((3, 130, 16), 130, (True,)))
        for causal in causals]
    served = None
    for (bh, tq, d), tk, dtype, causal in cases:
        q = torch.randn(bh, tq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(bh, tk, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(bh, tk, d, device="cuda", generator=gen).to(dtype)
        scale = d ** -0.5
        ref_o, ref_l = fa._reference_attention_lse(q, k, v, scale, causal)
        base = ref_o.float().abs() if dtype == torch.float32 else \
            error_scale(q, k, v, scale, causal, ref_l)
        for want_lse in (False, True):
            o, lse = fa._flash_forward_cuda(q, k, v, scale, causal,
                                            want_lse)
            torch.cuda.synchronize()
            d_o = o.float() - ref_o.float()
            err = d_o.abs()
            over = (err / (TOL[dtype]["atol"] + TOL[dtype]["rtol"]
                           * base)).max().item()
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
            iters = 20 if tq >= 1024 else 50
            ms = time_ms(lambda: fa._flash_forward_cuda(
                q, k, v, scale, causal, want_lse), iters)
            plain_ms = time_ms(lambda: fa._reference_attention_lse(
                q, k, v, scale, causal), 5)
            bound_ms, bound_by = attention_bound_ms(bh, tq, tk, d, dtype,
                                                    causal, want_lse)
            rec = dict(shape="(%d,%d,%d)x(%d,%d,%d)" % (bh, tq, d, bh, tk, d),
                       dtype=str(dtype).replace("torch.", ""),
                       causal=causal, lse=want_lse,
                       max_abs_err=err.max().item(), err_over_tol=over,
                       rel_l2=rel_l2, err_over_0_05=over_005,
                       max_abs_err_lse=err_lse,
                       ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None)
            if (bh, tq, d) == SERVED and not want_lse:
                b, h = 8, bh // 8
                q4, k4, v4 = (t.view(b, h, tq, d) for t in (q, k, v))
                sdpa = torch.nn.functional.scaled_dot_product_attention
                rec["library_ms"] = time_ms(
                    lambda: sdpa(q4, k4, v4, is_causal=True), iters)
                served = rec
            log("[kernel] " + json.dumps(rec))
            if not ok:
                fail("kernel disagrees with the plain version: %s" % rec)
    return served


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
    """The full-width next-token server; returns the kernel's launches
    during the served run."""
    cfg = tf.TransformerConfig(vocab=8192, d_model=1024, n_heads=8,
                               n_layers=8, d_ff=4096, max_len=1024,
                               dtype="bfloat16", remat="none")
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

    fa.FLASH_FWD.launches = 0
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
    drained = srv.drain(30)
    n_req = CLIENTS * PER_CLIENT
    if errors or any(t.is_alive() for t in threads) or not drained \
            or len(latencies) != n_req:
        fail("serve: errors %s, drained %s, %d of %d answered"
             % (errors[:3], drained, len(latencies), n_req))
    if launches != 8 * len(dispatches) or not dispatches:
        fail("serve: %d kernel launches for %d dispatches (want 8 each)"
             % (launches, len(dispatches)))
    rows = sum(x.shape[0] for reqs in requests for x in reqs)
    padded = sum(b for b, _ in dispatches[:n_loop])
    busy = sum(s for _, s in dispatches[:n_loop])
    buckets = {b: sum(1 for d, _ in dispatches[:n_loop] if d == b)
               for b in (1, 2, 4, 8)}
    p50, p99 = np.percentile(np.array(latencies) * 1e3, [50, 99])
    log("[serve] closed loop, %d clients: %d requests, %d rows, %d "
        "dispatches (by bucket %s), %d kernel launches in all"
        % (CLIENTS, n_req, rows, n_loop, buckets, launches))
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


def main():
    name_limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase_build()
    served = phase_kernel()
    launches = phase_serve()
    record = dict(name="flash_fwd", route="cuda",
                  source="mxtpu_torch/ops/csrc/flash_fwd.cu",
                  replaces="mxtpu/ops/pallas_attention.py:149",
                  launches=launches, max_abs_err=served["max_abs_err"],
                  ms=served["ms"], plain_ms=served["plain_ms"],
                  bound_ms=served["bound_ms"], bound_by=served["bound_by"],
                  library_ms=served["library_ms"])
    log(json.dumps({"kernels": [record]}))
    log(name_limit)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
