#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA card and nvcc, builds the
port's CUDA kernels from src/repro_torch/csrc into build/, and exits
non-zero, printing no result, when anything is missing or any phase fails:

1. environment: the card's name and power limit, torch and CUDA versions,
   the kernel build of the five sources (one nvcc each, in parallel,
   timed, with nvcc's register / shared-memory report);
2. every kernel of the serving paths against its plain PyTorch version at
   the full qwen3-1.7b shapes, with the tolerance stated, and timed with
   CUDA events (device time, L2 flushed before every launch; median of 50)
   beside its bound, the plain version and one PyTorch call as a yardstick
   where one exists: the word2ketXS lookup (at 8, 128 and 32,768 ids, each
   on the route ``ops.lookup_route`` picks, its other route and the stats
   leg holding the same bits, and both routes timed from 8 to 32,768 ids:
   the measurement behind ``ops.LOOKUP_ROWS_FROM``), the kron head, and the
   split-KV
   paged decode read (split and combine) at 32 and 256 pages per slot with
   ragged lengths (0, a partial page, one past the table) and a NaN-filled
   trash page;
3. slice 1's path at full width: the full qwen3-1.7b config with seeded
   random weights serves 8 prompts of 128 tokens (chunked prefill into the
   dense per-slot cache) and then 32 greedy decode steps, with the kernels'
   launch counts checked; a profile of one more prefill chunk and decode
   step (kernel time against the unprofiled wall time per call, so the
   device's busy and idle share, and the top kernels); then one full-width
   fp32 decode step through the kernels against ``use_kernels=False``;
4. slice 2's path at full width: ``ServingEngine`` (8 slots, max_len 512,
   bf16 activations) serves 16 requests of 128 tokens sharing a 64-token
   prefix, 32 new tokens each, twice: (a) with the prefix cache on the full
   pool, (b) without it on a 60-page pool that forces preemption. After
   every tick ``check()`` audits the pages; at the end every request is
   complete, every page free, every token in the vocabulary, and each
   kernel's launches match the ticks. Then a profile of one engine decode
   tick, and one full-width fp32 paged decode step held against the plain
   versions and against the dense-cache step;
5. slice 3's kernels (training) at full width, each against its plain
   version and timed as in phase 2: the kron_gather stats leg (its
   column-contiguous copy and its lookup also timed apart, by the
   profiler) and backward at 2,048 ids (repeated ids, 0 and vocab-1 among
   them; the backward run twice for the same bits), and the fused
   Kronecker-head CE forward and backward at 2,048 tokens (labels 0 and
   vocab-1 among them; both on their tensor-core routes, checked by their
   route counts, with their bounds also at the TF32 rate, one pass and the
   three of 3xTF32; the forward's losses also against a float64 forward,
   its CUDA-core kernel timed beside it, and both run twice for the same
   bits); the yardsticks are ``F.embedding`` forward and
   backward on the materialized 1.24 GB table, and ``torch.matmul`` on the
   materialized head plus ``F.cross_entropy`` (forward, and forward with
   backward);
6. slice 4's kernels (ket linears) at the four qwen3-1.7b ket-linear
   shapes at rank 8 (q/o, k/v, wi/wg, FFN wo): the kron_matmul forward at
   2,048 tokens and at 8 (serving) and its backward at 2,048 tokens, each
   against its plain version (the backward run twice for the same bits),
   timed beside its bound, the plain version and ``torch.matmul`` on the
   materialized weight (forward, and forward with backward);
7. slice 3's path at full width, after the serving state is freed: the
   full qwen3-1.7b trains for a few AdamW steps (no warmup) through
   ``make_train_step`` on ``synthetic.batch_at`` Markov batches of 8 x 256
   tokens, bf16 activations; every loss and grad norm finite, the last loss
   below the first, each training kernel launched exactly once per step
   (the CE forward and backward on their tensor-core routes every step),
   the peak device memory, and a profile of one step; then one full-width
   fp32 training step through the kernels against ``use_kernels=False``
   (loss, embedding and head factor gradients, one layer's weights after
   the AdamW update);
8. slice 4's path at full width: the same with ``linear_kind="ket"`` at
   rank 8 (every attention and FFN projection a Kronecker factor pair), the
   kron_matmul legs counted exactly (per step: 7 projections x 28 layers
   forward, as many again in the per-layer recompute, and as many
   backwards), then one fp32 step against ``use_kernels=False,
   linear_use_kernel=False`` (loss, the embedding, head and layer-0 factor
   gradients, layer 0 after AdamW);
9. slice 4's serving at full width: 8 prompts of 128 tokens prefilled in
   chunks of 16 and 8 greedy decode steps with ket projections, launch
   counts checked, a profile of one decode step, and one fp32 decode step
   against the plain versions;
10. slice 5's kernels (int8 / fp8 serving): the dequant-fused legs of the
   lookup (8, 128 and 32,768 ids, each the same bits as the fp32 leg on the
   dequantized stacks) and of the chain (the head at B = 8 and 1, the
   four rank-8 ket projections at B = 8 and 128) in both modes, each
   against its plain version and timed as in phase 2 beside its bound, its
   fp32 leg on the dequantized factors, the plain version and a yardstick
   (``F.embedding`` / ``torch.matmul`` on the dequantized materialized
   table or weight);
11. slice 5's path at full width: run (a) of phase 4 with
   ``quant="int8"`` (a profile of one quantized decode tick), the dense
   raw steps of phase 3 with ``quant="fp8"`` (8 decode steps, an fp32 step
   of the quantized model against the plain versions), ket serving at
   rank 8 with ``quant="int8"`` (the same checks); exact launch counts
   (no fp32 leg launched), the stored bytes of the embedding, head and ket
   linears per mode, and the share of greedy tokens that agree with the
   fp32 run of the same weights (a report, not a gate);
12. slice 6's kernels (run with the other kernel phases, before any
   model): the flash-attention forward at qwen3-1.7b's widths (16 heads
   over 8 kv heads, head_dim 128), ``flash_fwd_tc`` (the tensor-core
   kernel) on every bf16 case and ``flash_fwd`` (the CUDA-core kernel) on
   the fp32 one, against ``attention_ref`` at the training shape (8 x 256
   tokens, causal, bf16 and fp32), a window, a bidirectional and an Sq !=
   Skv case, and at the prefill shape (1 x 32,768 tokens, bf16, causal)
   against the model's plain chunked attention (``attention_ref``'s scores
   would take 68.7 GB there); every 16-bit case also row by row against
   the fp32 oracle on the same values (``attention_ref``, or the chunked
   attention at the prefill); each timed beside its bound (the operations
   of the valid pairs only, at the card's peak for the inputs' type: bf16
   tensor cores for bf16, fp32 CUDA cores for fp32), the plain version and
   ``F.scaled_dot_product_attention`` on the same tensors in (B, H, S, Dh)
   layout as a yardstick;
13. slice 6's path at full width: the full qwen3-1.7b with seeded weights
   runs ``prefill_fn`` on 1 prompt of 32,768 tokens in bf16 (the repo's
   ``prefill_32k`` length, its batch cut from 32 to 1): launch counts (28
   ``flash_fwd_tc`` launches, one lookup), wall time and prompt tok/s,
   peak memory, every cache's shape and finiteness, a profile of a second
   call; then a bf16 ``prefill_fn`` at 1 x 4,096 through the kernels
   against ``use_kernels=False``, row by row (the last hidden state and
   every layer's caches), and an fp32 one (28 ``flash_fwd`` launches)
   within atol / rtol. The bf16 training paths of phases 7 and 8 count 56
   ``flash_fwd_tc`` launches per step (28 forward, 28 in the per-layer
   recompute), their fp32 steps 56 ``flash_fwd``, and the serving paths
   none;
14. a JSON line of the kernels, then ``{"ok": true, "device": ...}`` last.

Only the prefill's batch is cut (32 -> 1): every path runs the published
28 layers (the whole script takes a few minutes on an H100).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit, dense): HBM3
# bytes/s, fp32 FLOP/s on the CUDA cores and bf16 / fp16 and TF32 FLOP/s on
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12

ARCH = "qwen3-1.7b"
BATCH, PROMPT_LEN, NEW_TOKENS, MAX_LEN = 8, 128, 32, 512
# the serving lookup at prefill_fn's 32,768 ids, and the id counts at which
# its fp32 leg's two routes are timed against each other
LOOKUP_LONG = 32768
LOOKUP_ROUTE_SCAN = (8, 128, 256, 512, 1024, 2048, 8192, LOOKUP_LONG)
# the plain lookup builds (ids, rank, q1*q2) rows: 8.6 GB at 32,768 ids, so
# it runs over chunks of this many ids
PLAIN_LOOKUP_CHUNK = 4096
GATHER_TOL = dict(atol=1e-4, rtol=1e-5)  # sums of 32 unit-variance LN rows;
# the kernel takes the order-2 LN moments by the separable formula
MATMUL_TOL = dict(atol=1e-4, rtol=1e-5)  # depth-(r*q2) fp32 sums, other order
MODEL_F32_ATOL = 1e-3  # 28 random fp32 layers may grow a ~1e-6 embedding difference
# training kernels: the stats leg takes the LN moments by the separable
# formula; the gather backward sums each factor column in token order, the
# plain version by index_add_; the CE kernels sum 1,024-deep products and
# 152,100 exponentials in another order, and the backward's dh and dF are
# sums of softmax - onehot terms that cancel; the kron_matmul backward sums
# dF over up to 196,608 rows in chunk partials, so these tolerances are
# scaled by the largest entry
STATS_TOL = dict(atol=1e-5, rtol=1e-4)
GATHER_BWD_SCALE, CE_BWD_SCALE = 1e-5, 1e-4  # atol = scale * max|plain|, rtol 1e-4
MATMUL_BWD_SCALE = 1e-5
# the ket linears of qwen3-1.7b at rank 8: (name, d_in, d_out, projections
# per layer); their factors are q (64, 32) -> t (64, 32), (32, 32), (96, 64)
# and q (96, 64) -> t (64, 32)
KET_RANK = 8
KET_SHAPES = (("q/o", 2048, 2048, 2), ("k/v", 2048, 1024, 2), ("wi/wg", 2048, 6144, 2),
              ("ffn wo", 6144, 2048, 1))
KET_DECODE_STEPS = 8
CE_LOSS_TOL = dict(atol=1e-4, rtol=1e-5)
TRAIN_TOKENS, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2048, 256, 5, 1e-3
# the fp32 training step: the loss and the factor gradients are sums over
# 2,048 tokens through 28 layers; AdamW moves a weight by up to lr either way
# when its gradient is near zero and differs in its last bits
TRAIN_F32_LOSS_ATOL, TRAIN_F32_GRAD_SCALE = 1e-4, 1e-3
# the paged read: fp32 partials differ only in summation order; with bf16
# pools a probability rounded to bf16 before the PV product may land one
# unit (2^-9 at 0.5) apart when its fp32 score differs in the last bit,
# times |v| up to about 5
PAGED_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1e-3)}
COMBINE_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 in, fp32 out, S terms
# ragged lengths per slot at 32 and 256 pages: 0, partial pages, one past
# the table (the pages past NP re-read its last entry)
RAGGED = {32: (0, 1, 17, 100, 144, 512, 600, 333),
          256: (0, 15, 1000, 2049, 4096, 4100, 3333, 4095)}
# lengths the timings use: mid-decode in the engine (128-token prompt + 16),
# and a full 4096-token read
TIMED_LEN = {32: 144, 256: 4096}
ENGINE_REQUESTS, SHARED_PREFIX, TIGHT_PAGES = 16, 64, 60
# the flash kernel against attention_ref: fp32 is the same online softmax
# in another summation order; in bf16 the outputs round to bf16 and the
# kernel rounds each probability to bf16 before the PV product (the oracle
# does not), and against the chunked attention the chunked version also
# rounds q * Dh^-0.5 back to bf16 (the kernel keeps it in fp32)
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=2e-4), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
# a bf16 output row (one query and head) against the fp32 oracle on the
# same values, relative to the row's norm: the kernel's two roundings (p
# and the output, 2^-9 relative each) stay near 2e-3, while a dropped or
# misplaced 64-key tile moves a row of the 32,768-token prefill by several
# per cent (8 / sqrt(row) at unit-normal q, k, v); the gate at the prefill,
# where the rows' elements are about sqrt(e / row) small
FLASH_ROW_RTOL = 1e-2
# (name, B, Sq, Skv, causal, window, dtype): the training shape first (the
# JSON row), then a window, bidirectional and Sq != Skv, and the prefill
FLASH_CASES = (("train", 8, 256, 256, True, 0, "bfloat16"),
               ("train fp32", 8, 256, 256, True, 0, "float32"),
               ("window 100", 8, 256, 256, True, 100, "bfloat16"),
               ("bidirectional", 8, 256, 256, False, 0, "bfloat16"),
               ("Sq != Skv", 8, 200, 333, True, 0, "bfloat16"),
               ("prefill", 1, 32768, 32768, True, 0, "bfloat16"))
PREFILL_LEN, PREFILL_F32_LEN = 32768, 4096
# the bf16 prefill at 4,096 tokens through the kernels against
# use_kernels=False, row by row (a row: the last hidden state, or one
# token's k or v in one kv head), relative to the plain row's norm. Layer
# 0's k and v come before any attention: they differ only where the
# lookup's fp32 sums, in another order, round to another bf16. Each layer's
# attention output differs between the routes by bf16 roundings (the
# kernel keeps q * Dh^-0.5 in fp32 and rounds p and o; the chunked
# attention rounds q * Dh^-0.5 to bf16 too), about 3e-3 of a row, and the
# residual stream carries that through 27 more layers of bf16 matmuls and
# adds (each rounding at 2^-9): a few 1e-3, up to about 1e-2 on the worst
# rows. A dropped or misplaced key tile changes a layer's attention rows
# by tens of per cent (8 / sqrt(row) at unit-normal values), and its next
# layer's k and v by a large part of that: 5e-2 separates the two.
PREFILL_BF16_LEN, PREFILL_BF16_ROW_RTOL = 4096, 5e-2
# the two flash kernels' launch counters, and their symbols in a profile
FLASH_KERNELS = ("flash_fwd", "flash_fwd_tc")
FLASH_GROUPS = {"flash kernel (tensor cores)": ["flash_fwd_tc_kernel"],
                "flash kernel (CUDA cores)": ["flash_fwd_kernel"]}
# the fp32 prefill through the kernels against use_kernels=False, every
# layer's caches: 28 random fp32 layers may grow the embedding's ~1e-6
# difference and the attention's summation order (the card tests' smoke
# tolerance)
PREFILL_F32_TOL = dict(atol=1e-4, rtol=1e-5)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int = 50, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``iters`` launches. Before each, the
    L2 is flushed (the serving loop reaches each kernel with a cold L2) and
    the card spins for ~1 ms, so the host has enqueued the whole call before
    the start event runs: the time is the device's, not the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(bytes_moved: float, flops: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want, tol, what: str) -> float:
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, **tol)
    log(f"  {what}: max |kernel - plain| = {err:.3e} "
        f"(atol {tol['atol']:g}, rtol {tol['rtol']:g}) {'ok' if ok else 'DISAGREES'}")
    if not ok:
        fail(f"{what}: kernel disagrees with its plain version")
    return err


def chunked(torch, fn, ids):
    """``fn`` over ``ids`` in chunks of PLAIN_LOOKUP_CHUNK, concatenated."""
    return torch.cat([fn(part) for part in torch.split(ids, PLAIN_LOOKUP_CHUNK)])


def check_kernels(torch, dev):
    """Phase 2: each kernel against its plain version at full width, timed."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import embedding_for, head_for
    from repro_torch.core import ketops
    from repro_torch.core.kron import mixed_radix_digits
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.kernels.kron_matmul import ops as M

    cfg = get_config(ARCH)
    espec, hspec = embedding_for(cfg).spec, head_for(cfg).spec
    gen = torch.Generator(device=dev).manual_seed(1)
    ef = ketops.init(gen, espec, dev)["factors"]
    hf = ketops.init(gen, hspec, dev)["factors"]
    r, (q1, q2), (t1, t2) = espec.rank, espec.resolved_q(), espec.resolved_t()
    P, V = espec.in_dim, cfg.vocab_size
    scratch = torch.empty(16 * 2 ** 20, dtype=torch.int32, device=dev)  # 64 MB > L2
    flush = scratch.zero_
    results = []

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"[kernels] kron_gather_fwd: F1 {tuple(ef[0].shape)}, F2 {tuple(ef[1].shape)} fp32, "
        f"LN on, out (N, {P})")
    gathers = {}
    for n in (BATCH * cfg.prefill_chunk, BATCH, 131, LOOKUP_LONG):
        ids = torch.randint(0, V, (n,), generator=gen, device=dev, dtype=torch.int32)
        ids[0], ids[-1] = 0, V - 1
        got = G.kron_gather(ef, ids, P, True)
        torch.cuda.synchronize()
        want = chunked(torch, lambda part: G.kron_gather(ef, part, P, True, use_kernel=False),
                       ids)
        gathers[n] = (ids, max_err(torch, got, want, GATHER_TOL, f"N={n}"))
        del want
        # the serving leg's bits: its other route and the stats leg give the same
        route = G.lookup_route(n)
        other = G.kron_gather_cuda(ef, ids, P, True,
                                   route="rows" if route == "strided" else "strided")
        stats_out = G.kron_gather_cuda(ef, ids, P, True, with_stats=True)[0]
        if not (torch.equal(got, other) and torch.equal(got, stats_out)):
            fail(f"kron_gather N={n}: the serving leg's routes or the stats leg disagree in "
                 f"their bits")
        log(f"  N={n}: route {route!r}, {G.lookup_bands(n, q1, sms)} block(s) per id; the "
            f"other route and the stats leg give the same bits")
        del got, other, stats_out
    # the fp32 serving leg's route threshold (ops.LOOKUP_ROWS_FROM): both
    # routes timed over the id counts of decode, prefill chunks and prefill_fn
    log("  the two routes of the fp32 serving leg (L2 flushed, median of 20):")
    for n in LOOKUP_ROUTE_SCAN:
        ids = torch.randint(0, V, (n,), generator=gen, device=dev, dtype=torch.int32)
        t = {rt: time_ms(torch, lambda: G.kron_gather_cuda(ef, ids, P, True, route=rt), flush,
                         iters=20) for rt in ("strided", "rows")}
        fast = min(t, key=t.get)
        log(f"    N={n:6d}: strided {t['strided']:.4f} ms, rows {t['rows']:.4f} ms; faster "
            f"{fast!r}, lookup_route {G.lookup_route(n)!r}")
    table = torch.cat([G.kron_gather(ef, part, P, True) for part in
                       torch.split(torch.arange(V, device=dev, dtype=torch.int32), 8192)])
    for n in (BATCH * cfg.prefill_chunk, BATCH, LOOKUP_LONG):
        ids, err = gathers[n]
        d1, d2 = mixed_radix_digits(ids.long(), (t1, t2))
        cols = d1.unique().numel() * r * q1 + d2.unique().numel() * r * q2
        b_ms, b_by = bound(4 * (n + cols + n * P), 2.0 * n * r * (P + q1 + q2))
        ids_long = ids.long()
        iters = 5 if n == LOOKUP_LONG else 50
        entry = {
            "name": "kron_gather_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/kron_gather.cu",
            "replaces": "src/repro/kernels/kron_gather/kron_gather.py:57",
            "shape": f"ids ({n},) -> ({n}, {P})",
            "lookup_route": G.lookup_route(n), "bands": G.lookup_bands(n, q1, sms),
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: G.kron_gather(ef, ids, P, True), flush,
                          iters=max(iters, 20)),
            "plain_ms": time_ms(torch, lambda: chunked(
                torch, lambda part: G.kron_gather(ef, part, P, True, use_kernel=False), ids),
                flush, iters=iters),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, lambda: torch.nn.functional.embedding(
                ids_long, table), flush, iters=max(iters, 20)),
        }
        results.append(entry)
    del table, gathers

    log(f"[kernels] kron_matmul_fwd: F1 {tuple(hf[0].shape)}, F2 {tuple(hf[1].shape)} fp32, "
        f"out (B, {V})")
    head = M.kron_matmul(hf, torch.eye(P, device=dev), V)  # (P, V) dense yardstick
    for b in (BATCH, 1):
        x = torch.randn((b, P), generator=gen, device=dev)
        got = M.kron_matmul(hf, x, V)
        torch.cuda.synchronize()
        err = max_err(torch, got, M.kron_matmul(hf, x, V, use_kernel=False), MATMUL_TOL,
                      f"B={b}")
        flops = 2.0 * b * (r * t1 * q1 * q2 + r * q2 * t1 * t2)
        b_ms, b_by = bound(4 * (b * P + sum(f.numel() for f in hf) + b * V), flops)
        results.append({
            "name": "kron_matmul_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/kron_matmul.cu",
            "replaces": "src/repro/kernels/kron_matmul/kron_matmul.py:54",
            "shape": f"x ({b}, {P}) -> ({b}, {V})",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: M.kron_matmul(hf, x, V), flush),
            "plain_ms": time_ms(torch, lambda: M.kron_matmul(hf, x, V, use_kernel=False),
                                flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, lambda: torch.matmul(x, head), flush),
        })
    del head, scratch
    torch.cuda.empty_cache()
    for e in results:
        how = f" [{e['lookup_route']}, {e['bands']} band(s)]" if "bands" in e else ""
        log(f"  {e['name']:16s} {e['shape']:34s}{how} kernel {e['ms']:.4f} ms  "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})  plain {e['plain_ms']:.4f} ms  "
            f"library {e['library_ms']:.4f} ms")
    # the JSON line keeps one row per kernel: the decode-step shape, which
    # every decode step gives both kernels (prefill gives kron_matmul the same)
    return [e for e in results
            if e["shape"].startswith((f"ids ({BATCH},)", f"x ({BATCH},"))]


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs of a head that pass the mask: the work the flash
    kernel's bound counts."""
    total = 0
    for i in range(Sq):
        hi = min(i, Skv - 1) if causal else Skv - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def check_flash_kernels(torch, dev):
    """Phase 12: the flash-attention forward against its plain versions at
    qwen3-1.7b's widths, timed beside its bound, the plain version and SDPA:
    the tensor-core kernel on every bf16 case, the CUDA-core kernel on the
    fp32 one. Returns the JSON rows of the training and prefill shapes."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.models import attention as A

    cfg = get_config(ARCH)
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(11)
    scratch = torch.empty(16 * 2 ** 20, dtype=torch.int32, device=dev)  # 64 MB > L2
    flush = scratch.zero_
    results = []
    for name, B, Sq, Skv, causal, window, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((B, Sq, H, Dh), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Skv, KVH, Dh), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Skv, KVH, Dh), generator=gen, device=dev).to(dt)
        kern = FA.flash_route(dt, Dh)  # bf16: the tensor cores; fp32: the CUDA cores
        log(f"[kernels] {kern} {name}: q ({B}, {Sq}, {H}, {Dh}), k, v ({B}, {Skv}, "
            f"{KVH}, {Dh}) {dtype}, causal {causal}, window {window}")
        before = FA.launches[kern]
        got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if FA.launches[kern] != before + 1:
            fail(f"{kern} {name}: the call did not launch {kern}")
        if not torch.isfinite(got).all():
            fail(f"{kern} {name}: non-finite output")
        big = name == "prefill"
        if big:  # the oracle's scores would take 68.7 GB here
            plain = lambda: A.flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
            oracle32 = lambda: A.flash_attention(q.float(), k.float(), v.float(), causal=True,
                                                 chunk=cfg.attn_chunk)
        else:
            plain = lambda: FA.attention_ref(q, k, v, causal=causal, window=window)
            oracle32 = lambda: FA.attention_ref(q.float(), k.float(), v.float(),
                                                causal=causal, window=window)
        err = max_err(torch, got.float(), plain().float(), FLASH_TOL[dtype],
                      f"{kern} {name} vs {'the chunked attention' if big else 'attention_ref'}")
        worst = None
        if dtype != "float32":
            want = oracle32()
            row = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
            worst, mid = row.max().item(), row.median().item()
            what = "the fp32 chunked attention" if big else "fp32 attention_ref"
            log(f"  {kern} {name} vs {what} on the same values: max |diff| "
                f"{(got.float() - want).abs().max().item():.3e}, |o| median "
                f"{want.abs().median().item():.3e}; per-row relative error max {worst:.3e}, "
                f"median {mid:.3e} (limit {FLASH_ROW_RTOL:g}) "
                f"{'ok' if worst <= FLASH_ROW_RTOL else 'DISAGREES'}")
            if not worst <= FLASH_ROW_RTOL:
                fail(f"{kern} {name}: a row is {worst:.3e} off the fp32 oracle")
            del want, row
        # the yardstick on the same tensors in (B, H, S, Dh) layout
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window > 0:
            i = torch.arange(Sq, device=dev)[:, None]
            j = torch.arange(Skv, device=dev)[None, :]
            mask = (j <= i) & (j > i - window)
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                          enable_gqa=True)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                          enable_gqa=True)
        diff = (sdpa().transpose(1, 2).float() - got.float()).abs().max().item()
        log(f"  sdpa vs kernel max |diff| = {diff:.3e}")
        pairs = attention_pairs(Sq, Skv, causal, window)
        moved = sum(t.numel() * t.element_size() for t in (q, k, v, got))
        flops = 4.0 * B * H * Dh * pairs
        b_ms, b_by = bound(moved, flops,
                           PEAK_FP32_FLOPS if dtype == "float32" else PEAK_BF16_FLOPS)
        results.append({
            "name": kern, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn/flash_attn.py:27",
            "shape": f"{name}: q ({B}, {Sq}, {H}, {Dh}), kv ({B}, {Skv}, {KVH}, {Dh}) "
                     f"{dtype}",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: FA.flash_attention_cuda(q, k, v, causal=causal,
                                                                 window=window),
                          flush, iters=5 if big else 50, warmup=1 if big else 5),
            "plain_ms": time_ms(torch, plain, flush, iters=3 if big else 20,
                                warmup=1 if big else 3),
            "bound_ms": b_ms, "bound_by": b_by,
            # the same work on the fp32 CUDA cores, where the fp32 kernel computes
            "bound_cuda_cores_ms": bound(moved, flops)[0],
            "library_ms": time_ms(torch, sdpa, flush, iters=10 if big else 50),
            "library": "F.scaled_dot_product_attention on the same tensors in (B, H, S, "
                       "Dh) layout" + (" with a boolean window mask" if window else ""),
            "plain": "the model's chunked attention" if big else "attention_ref",
            "max_row_rel_err_vs_fp32": worst,
        })
        del q, k, v, got, qt, kt, vt
        torch.cuda.empty_cache()
    del scratch
    torch.cuda.empty_cache()
    for e in results:
        log(f"  {e['name']:12s} {e['shape']:62s} kernel {e['ms']:.4f} ms  bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']}; on the fp32 CUDA cores "
            f"{e['bound_cuda_cores_ms']:.4f} ms)  plain ({e['plain']}) "
            f"{e['plain_ms']:.4f} ms  sdpa {e['library_ms']:.4f} ms")
    # the JSON line: each kernel at the training shape, and the tensor-core
    # kernel at the prefill shape
    return [e for e in results if e["shape"].startswith(("train", "prefill"))]


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.kernels.kron_logits import ops as CE
    from repro_torch.kernels.kron_matmul import ops as M

    for counts in (FA.launches, G.launches, CE.launches, CE.routes, M.launches):
        for k in counts:
            counts[k] = 0


def profile_call(torch, what: str, fn, wall_ms: float, groups=None) -> None:
    """Device time of one call by kernel (torch.profiler over CUPTI) against
    ``wall_ms``, the call's unprofiled wall time: the device's busy and idle
    share. Prints "not measured" when the trace holds no kernel. ``groups``
    ({kind: name substrings}) adds the device time summed by kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    kernels = sorted((e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"[profile] {what}: device time not measured (no kernel in the trace)")
        return
    log(f"[profile] {what}: kernels {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"(device busy {100 * busy_ms / wall_ms:.1f}%, idle "
        f"{100 * max(0.0, 1 - busy_ms / wall_ms):.1f}%); top kernels:")
    for e in kernels[:8]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")
    if groups:
        sums = dict.fromkeys(list(groups) + ["other"], 0.0)
        for e in kernels:
            name = next((g for g, keys in groups.items() if any(k in e.key for k in keys)),
                        "other")
            sums[name] += dev_us(e) / 1e3
        log(f"[profile] {what} by kind: " + ", ".join(f"{g} {ms:.3f} ms"
                                                      for g, ms in sums.items()))


def init_params(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = MD.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"[main] {cfg.name}: {MD.param_count(params):,} params (fp32) initialised in "
        f"{time.perf_counter() - t0:.1f} s; activations {cfg.dtype}")
    return params


def drive_main_path(torch, dev, params, quant: str = "none", steps: int = NEW_TOKENS):
    """Phase 3: the full config serving 8 prompts, launch counts checked;
    with ``quant`` (phase 11) on ``params`` quantized here, ``steps`` decode
    steps. Returns the launches and the greedy tokens (steps + 1, 8)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_params
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.kernels.kron_matmul import ops as M
    from repro_torch.models import model as MD

    cfg = get_config(ARCH)
    tag = "main" if quant == "none" else f"{quant} serve"
    params = quantize_params(params, quant)
    C = cfg.prefill_chunk
    gen = torch.Generator(device=dev).manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen,
                            device=dev, dtype=torch.int32)
    lens = torch.full((BATCH,), C, device=dev, dtype=torch.int32)

    with torch.inference_mode():
        warm = MD.init_cache(cfg, BATCH, MAX_LEN, device=dev)  # first-call set-up
        logits, warm = MD.prefill_chunk_fn(params, cfg, warm, prompts[:, :C], lens)
        MD.serve_step_fn(params, cfg, warm, logits.argmax(-1).to(torch.int32))
        del warm
        cache = MD.init_cache(cfg, BATCH, MAX_LEN, device=dev)
        torch.cuda.synchronize()

        reset_counts()
        t0 = time.perf_counter()
        for c0 in range(0, PROMPT_LEN, C):
            logits, cache = MD.prefill_chunk_fn(params, cfg, cache, prompts[:, c0:c0 + C],
                                                lens)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        tok = logits.argmax(-1).to(torch.int32)
        generated = [tok]
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = MD.serve_step_fn(params, cfg, cache, tok)
            tok = logits.argmax(-1).to(torch.int32)
            generated.append(tok)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        launches = {**{k: G.launches[k] for k in ("kron_gather_fwd", "kron_gather_fwd_quant")},
                    **{k: M.launches[k] for k in ("kron_matmul_fwd", "kron_matmul_fwd_quant")},
                    **{k: FA.launches[k] for k in FLASH_KERNELS}}

    n_chunks = PROMPT_LEN // C
    calls = n_chunks + steps  # one launch of each leg per prefill chunk and per step
    leg = "" if quant == "none" else "_quant"
    expected = {k: 0 for k in launches}
    expected[f"kron_gather_fwd{leg}"] = expected[f"kron_matmul_fwd{leg}"] = calls
    log(f"[{tag}] launches {launches} (expected {expected}: {n_chunks} prefill chunks + "
        f"{steps} decode steps)")
    if launches != expected:
        fail(f"{tag}: launches {launches}, expected {expected}")
    if tuple(logits.shape) != (BATCH, cfg.vocab_size) or logits.dtype != torch.float32:
        fail(f"logits {tuple(logits.shape)} {logits.dtype}, expected ({BATCH}, "
             f"{cfg.vocab_size}) float32")
    if not torch.isfinite(logits).all():
        fail("non-finite logits")
    toks = torch.stack(generated)
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail("a generated token lies outside the vocabulary")
    if not torch.equal(cache["step"], torch.full_like(cache["step"], PROMPT_LEN + steps)):
        fail(f"cache steps {cache['step'].tolist()}")
    log(f"[{tag}] prefill {BATCH}x{PROMPT_LEN} tokens in {n_chunks} chunks: {t_prefill:.3f} s "
        f"({BATCH * PROMPT_LEN / t_prefill:.0f} prompt tok/s); decode {steps} steps: "
        f"{t_decode:.3f} s ({BATCH * steps / t_decode:.0f} gen tok/s, "
        f"{t_decode / steps * 1e3:.2f} ms/step); tokens in [0, {cfg.vocab_size}), "
        f"logits finite")

    if quant == "none":
        with torch.inference_mode():
            profile_call(torch, "one prefill chunk", lambda: MD.prefill_chunk_fn(
                params, cfg, cache, prompts[:, :C], lens), t_prefill / n_chunks * 1e3)
            profile_call(torch, "one decode step", lambda: MD.serve_step_fn(
                params, cfg, cache, tok), t_decode / steps * 1e3)

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    outs = []
    with torch.inference_mode():
        for c in (cfg32, dataclasses.replace(cfg32, use_kernels=False)):
            cache32 = MD.init_cache(c, BATCH, 8, device=dev)
            outs.append(MD.serve_step_fn(params, c, cache32, tok)[0])
            del cache32
    diff = (outs[0] - outs[1]).abs().max().item()
    log(f"[{tag}] fp32 decode step, kernel route vs use_kernels=False: max |dlogit| = "
        f"{diff:.3e} (atol {MODEL_F32_ATOL:g}), |logit| max {outs[1].abs().max().item():.3f}")
    if not diff <= MODEL_F32_ATOL:
        fail(f"{tag}: the kernel route and the plain versions disagree on the full model")
    return launches, torch.stack(generated)


def paged_inputs(torch, dev, cfg, dtype, NP, lens, gen):
    """q, pools with a NaN trash page (row 0), a permuted page table whose
    entries past each slot's valid pages are trash (a slot longer than the
    table keeps every entry), lens."""
    B, H, KVH, Dh, ps = BATCH, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.page_size
    P = 1 + B * NP
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, ps, KVH, Dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, ps, KVH, Dh), generator=gen, device=dev).to(dtype)
    kp[0] = float("nan")
    vp[0] = float("nan")
    ptab = (torch.randperm(P - 1, generator=gen, device=dev) + 1).reshape(B, NP)
    for b, n in enumerate(lens):
        ptab[b, -(-n // ps):] = 0
    return (q, kp, vp, ptab.to(torch.int32),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def check_paged_kernels(torch, dev):
    """Phase 2, slice 2: the split-KV paged read against its plain versions
    at full width, timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attn import ops as FA

    cfg = get_config(ARCH)
    B, H, KVH, Dh, ps = BATCH, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.page_size
    G = H // KVH
    gen = torch.Generator(device=dev).manual_seed(3)
    scratch = torch.empty(16 * 2 ** 20, dtype=torch.int32, device=dev)  # 64 MB > L2
    flush = scratch.zero_
    results = []
    for NP in (32, 256):
        S = autotune.heuristic_kv_splits(ps, G, Dh, NP, batch=B)
        log(f"[kernels] paged_split + paged_combine: B={B}, {H} heads over {KVH} kv heads, "
            f"Dh {Dh}, {NP} pages of {ps} per slot, {S} splits, lens {RAGGED[NP]}, "
            f"NaN trash page")
        errs = {}
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            args = paged_inputs(torch, dev, cfg, dtype, NP, RAGGED[NP], gen)
            got = FA.paged_attention_split(*args, kv_splits=S)
            out = FA.combine_splits(*got)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(t).all()) for t in (*got, out)):
                fail(f"non-finite paged output at NP={NP} {name}")
            want = FA.paged_attention_split(*args, kv_splits=S, use_kernel=False)
            split_err = max(max_err(torch, g, w, PAGED_TOL[name],
                                    f"split {part} NP={NP} {name}")
                            for part, g, w in zip(("mid_o", "m", "l"), got, want))
            comb_err = max_err(torch, out, FA.combine_splits(*got, use_kernel=False),
                               COMBINE_TOL, f"combine NP={NP} {name}")
            if not bool((out[0] == 0).all()):
                fail("a slot with lens 0 did not combine to 0")
            errs[name] = (split_err, comb_err)

        n = TIMED_LEN[NP]
        q, kp, vp, ptab, lens = paged_inputs(torch, dev, cfg, torch.bfloat16, NP, [n] * B, gen)
        parts = FA.paged_attention_split(q, kp, vp, ptab, lens, kv_splits=S)
        # the yardstick reads the same K/V already laid out dense (gather excluded)
        kd = kp[ptab.long()].reshape(B, NP * ps, KVH, Dh)[:, :n].transpose(1, 2).contiguous()
        vd = vp[ptab.long()].reshape(B, NP * ps, KVH, Dh)[:, :n].transpose(1, 2).contiguous()
        q4 = q[:, :, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ref = FA.combine_splits(*parts).reshape(B, H, Dh)
        diff = (sdpa(q4, kd, vd, enable_gqa=True)[:, :, 0].float() - ref).abs().max().item()
        log(f"  timed read ({n} tokens per slot, bf16): split+combine vs sdpa on dense K/V "
            f"max |diff| = {diff:.3e}")
        tokens = B * n
        part_bytes = sum(t.numel() * 4 for t in parts)
        split_bytes = (tokens * KVH * Dh * 2 * kp.element_size() + q.numel() * q.element_size()
                       + ptab.numel() * 4 + lens.numel() * 4 + part_bytes)
        b_ms, b_by = bound(split_bytes, 4.0 * tokens * H * Dh)
        shape = f"B={B} NP={NP} lens={n} S={S}"
        results.append({
            "name": "paged_split", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/flash_attn/paged.py:85",
            "shape": shape, "max_abs_err": errs["bfloat16"][0],
            "ms": time_ms(torch, lambda: FA.paged_attention_split(
                q, kp, vp, ptab, lens, kv_splits=S), flush),
            "plain_ms": time_ms(torch, lambda: FA.paged_attention_split(
                q, kp, vp, ptab, lens, kv_splits=S, use_kernel=False), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, lambda: sdpa(q4, kd, vd, enable_gqa=True), flush),
            "library": "F.scaled_dot_product_attention over the same K/V laid out dense "
                       "(gather excluded)",
        })
        out_bytes = B * KVH * G * Dh * 4
        b_ms, b_by = bound(part_bytes + out_bytes, 3.0 * parts[0].numel())
        results.append({
            "name": "paged_combine", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/flash_attn/paged.py:175",
            "shape": shape, "max_abs_err": errs["bfloat16"][1],
            "ms": time_ms(torch, lambda: FA.combine_splits(*parts), flush),
            "plain_ms": time_ms(torch, lambda: FA.combine_splits(*parts, use_kernel=False),
                                flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "library": "none (no single PyTorch call merges partials)",
        })
        del q, kp, vp, kd, vd, parts
    del scratch
    torch.cuda.empty_cache()
    for e in results:
        lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms"
        log(f"  {e['name']:14s} {e['shape']:30s} kernel {e['ms']:.4f} ms  "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})  plain {e['plain_ms']:.4f} ms  "
            f"library {lib}")
    # the JSON line keeps the engine's decode shape (32 pages per slot)
    return [e for e in results if " NP=32 " in e["shape"]]


def run_engine(torch, dev, cfg, params, prompts, what, **kw):
    """One engine drain with ``check()`` after every tick; returns (engine,
    stats, launches during the drain, decode-tick wall times in ms)."""
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.kernels.kron_matmul import ops as M
    from repro_torch.serve.engine import Request, ServingEngine

    eng = ServingEngine(cfg, params, batch_slots=BATCH, max_len=MAX_LEN, device=dev, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    reset_counts()
    decode_ms = []
    while eng.has_work():
        if eng._tick >= 2000:
            fail(f"engine {what} did not drain in 2000 ticks")
        before = eng.decode_ticks
        t0 = time.perf_counter()
        eng.step()  # ends in a host read of the sampled tokens: a sync
        dt = (time.perf_counter() - t0) * 1e3
        if eng.decode_ticks > before:
            decode_ms.append(dt)
        eng.check()
    launches = {**{k: G.launches[k] for k in ("kron_gather_fwd", "kron_gather_fwd_quant")},
                **{k: M.launches[k] for k in ("kron_matmul_fwd", "kron_matmul_fwd_quant")},
                "paged_split": FA.launches["paged_split"],
                "paged_combine": FA.launches["paged_combine"],
                **{k: FA.launches[k] for k in FLASH_KERNELS}}
    st = eng.stats()
    if eng.prefix_cache is not None:  # at drain only the cache holds pages
        eng.prefix_cache.evict(len(eng.prefix_cache))
    free, cap = eng.page_stats()["free_pages"], eng.page_stats()["page_capacity"]
    log(f"[engine {what}] {st['completed']} completed, {st['failed']} failed; "
        f"{st['prefill_ticks']} prefill + {st['decode_ticks']} decode ticks, "
        f"{st['stalled_ticks']} stalled; preemptions {st['preemptions']}, prefix hit pages "
        f"{st['prefix_hit_pages']}, cow {st['cow_copies']}; kv_splits "
        f"{eng.cfg.decode_kv_splits}; pages free {free}/{cap}")
    log(f"[engine {what}] {st['tokens_per_sec']:.1f} gen tok/s, "
        f"{st['prompt_tokens_per_sec']:.1f} prompt tok/s, latency p50 "
        f"{st['p50_latency_s']:.3f} s p95 {st['p95_latency_s']:.3f} s, TTFT p50 "
        f"{st['ttft_p50_s']:.3f} s; decode tick median "
        f"{statistics.median(decode_ms):.2f} ms over {len(decode_ms)}")
    # one lookup and one head chain per tick, on the quantized legs when
    # the engine calibrated its parameters, and none on the others
    leg = "_quant" if kw.get("quant", "none") != "none" else ""
    expected = {"kron_gather_fwd": 0, "kron_gather_fwd_quant": 0, "kron_matmul_fwd": 0,
                "kron_matmul_fwd_quant": 0,
                "paged_split": cfg.num_layers * st["decode_ticks"],
                "paged_combine": cfg.num_layers * st["decode_ticks"], "flash_fwd": 0,
                "flash_fwd_tc": 0}
    expected[f"kron_gather_fwd{leg}"] = expected[f"kron_matmul_fwd{leg}"] = st["ticks"]
    log(f"[engine {what}] launches {launches} (expected {expected})")
    if launches != expected:
        fail(f"engine {what}: launches {launches}, expected {expected}")
    if st["completed"] != len(prompts) or st["failed"] or free != cap:
        fail(f"engine {what}: {st['completed']} completed, {st['failed']} failed, "
             f"pages free {free}/{cap}")
    for r in reqs:
        if len(r.output) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in r.output):
            fail(f"engine {what}: request {r.uid} gave {r.output}")
    return eng, st, launches, [r.output for r in reqs]


def drive_engine(torch, dev, params, quant: str = "none"):
    """Phase 4: slice 2's path, ServingEngine at full width, runs (a) and
    (b); with ``quant`` (phase 11) run (a) only, the engine calibrating
    ``params`` at construction. Returns run (a)'s launches and outputs."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import Request
    from repro_torch.serve.faultinject import shared_prefix_prompts

    cfg = get_config(ARCH)
    prompts = shared_prefix_prompts(4, ENGINE_REQUESTS, SHARED_PREFIX,
                                    PROMPT_LEN - SHARED_PREFIX, cfg.vocab_size)
    what = "a" if quant == "none" else f"a {quant}"
    with torch.inference_mode():
        eng, st, launches, outputs = run_engine(torch, dev, cfg, params, prompts, what,
                                                prefix_cache=True, quant=quant)
        if st["prefix_hit_pages"] <= 0:
            fail(f"engine {what}: the shared prefix never hit the prefix cache")

        # one more decode tick, profiled: 8 short requests, prefilled, then
        # three unprofiled decode ticks give the wall time per tick
        gen = torch.Generator().manual_seed(5)
        for i in range(BATCH):
            eng.submit(Request(uid=100 + i, max_new_tokens=8, prompt=torch.randint(
                0, cfg.vocab_size, (cfg.prefill_chunk,), generator=gen).tolist()))
        while any(eng.slot_pending) or eng.queue:
            eng.step()
        walls = []
        for _ in range(3):
            before, t0 = eng.decode_ticks, time.perf_counter()
            eng.step()
            walls.append((time.perf_counter() - t0) * 1e3)
            if eng.decode_ticks != before + 1:
                fail("the profiled engine tick is not a decode tick")
        before = eng.decode_ticks
        mode = "" if quant == "none" else f", {quant}"
        profile_call(torch, f"one engine decode tick (8 slots, paged{mode})", eng.step,
                     statistics.median(walls))
        if eng.decode_ticks != before + 1:
            fail("the profiled engine tick is not a decode tick")
        eng.run_until_drained()
        del eng
        torch.cuda.empty_cache()
        if quant != "none":
            return launches, outputs

        _, st_b, _, _ = run_engine(torch, dev, cfg, params, prompts, "b",
                                   num_pages=TIGHT_PAGES)
        if st_b["preemptions"] < 1:
            fail(f"engine b: no preemption on a {TIGHT_PAGES}-page pool")
    return launches, outputs


def check_paged_step_fp32(torch, dev, params):
    """One full-width fp32 paged decode step after a 128-token prefill,
    through the kernels against the plain versions, and against the dense
    cache."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.models import model as MD
    from repro_torch.serve.cache import identity_ptab

    cfg32 = dataclasses.replace(get_config(ARCH), dtype=torch.float32)
    C = cfg32.prefill_chunk
    gen = torch.Generator(device=dev).manual_seed(6)
    prompts = torch.randint(0, cfg32.vocab_size, (BATCH, PROMPT_LEN), generator=gen,
                            device=dev, dtype=torch.int32)
    lens = torch.full((BATCH,), C, device=dev, dtype=torch.int32)
    outs, tok = {}, None
    with torch.inference_mode():
        for name, c, paged in (("kernels", cfg32, True),
                               ("plain", dataclasses.replace(cfg32, use_kernels=False), True),
                               ("dense", cfg32, False)):
            cache = MD.init_cache(c, BATCH, MAX_LEN, paged=paged, device=dev)
            if paged:
                identity_ptab(cache, BATCH)
            for c0 in range(0, PROMPT_LEN, C):
                logits, cache = MD.prefill_chunk_fn(params, c, cache,
                                                    prompts[:, c0:c0 + C], lens)
            if tok is None:
                tok = logits.argmax(-1).to(torch.int32)
            before = FA.launches["paged_split"]
            outs[name] = MD.serve_step_fn(params, c, cache, tok)[0]
            if name == "kernels" and FA.launches["paged_split"] != before + cfg32.num_layers:
                fail("the fp32 paged step did not run the split kernel in every layer")
            del cache
    for other in ("plain", "dense"):
        diff = (outs["kernels"] - outs[other]).abs().max().item()
        log(f"[paged] fp32 decode step after {PROMPT_LEN} tokens, paged kernel route vs "
            f"{other}: max |dlogit| = {diff:.3e} (atol {MODEL_F32_ATOL:g}), |logit| max "
            f"{outs[other].abs().max().item():.3f}")
        if not diff <= MODEL_F32_ATOL:
            fail(f"the paged kernel route and the {other} step disagree on the full model")


def check_training_kernels(torch, dev):
    """Phase 5: slice 3's kernels against their plain versions at full
    width, timed beside their bounds and yardsticks."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.configs.base import embedding_for, head_for
    from repro_torch.core import ketops
    from repro_torch.core.kron import mixed_radix_digits
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.kernels.kron_logits import ops as CE
    from repro_torch.kernels.kron_matmul import ops as M

    cfg = get_config(ARCH)
    espec, hspec = embedding_for(cfg).spec, head_for(cfg).spec
    gen = torch.Generator(device=dev).manual_seed(7)
    ef = ketops.init(gen, espec, dev)["factors"]
    hf = ketops.init(gen, hspec, dev)["factors"]
    r, (q1, q2), (t1, t2) = espec.rank, espec.resolved_q(), espec.resolved_t()
    P, V, N = espec.in_dim, cfg.vocab_size, TRAIN_TOKENS
    fbytes = 4 * sum(f.numel() for f in ef)
    scratch = torch.empty(16 * 2 ** 20, dtype=torch.int32, device=dev)  # 64 MB > L2
    flush = scratch.zero_
    results = []

    def scaled(got, want, scale, what):
        return max_err(torch, got, want, dict(atol=scale * want.abs().max().item(),
                                              rtol=1e-4), what)

    ids = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
    ids[0], ids[-1], ids[1:64] = 0, V - 1, ids[64:127]  # repeated ids
    log(f"[kernels] kron_gather stats leg and backward: N={N} ids ({ids.unique().numel()} "
        f"distinct), F1 {tuple(ef[0].shape)}, F2 {tuple(ef[1].shape)} fp32, LN on")
    out, stats = G.kron_gather_cuda(ef, ids, P, True, with_stats=True)
    torch.cuda.synchronize()
    want_out, want_stats = G.kron_gather_fwd_ref(ef, ids, embed_dim=P)
    err_out = max_err(torch, out, want_out, GATHER_TOL, "stats leg out")
    err_stats = max_err(torch, stats, want_stats, STATS_TOL, "stats leg (mean, rstd)")
    g = torch.randn((N, P), generator=gen, device=dev)
    dfs = G.kron_gather_bwd_cuda(ef, ids, g, stats)
    torch.cuda.synchronize()
    want_dfs = G.kron_gather_bwd_ref(ef, ids, g, want_stats)
    err_bwd = max(scaled(a, b, GATHER_BWD_SCALE, f"gather backward dF{j + 1}")
                  for j, (a, b) in enumerate(zip(dfs, want_dfs)))
    if not all(torch.equal(a, b) for a, b in zip(G.kron_gather_bwd_cuda(ef, ids, g, stats),
                                                 dfs)):
        fail("the gather backward gave other bits on a second run")
    log("  gather backward: the same bits on a second run")
    split = kernel_times(torch, lambda: G.kron_gather_cuda(ef, ids, P, True, with_stats=True),
                         {"column-contiguous copy": "transpose_factors_kernel",
                          "lookup": "kron_gather2_kernel"})
    log("  stats leg by kernel (profiler, warm L2, mean of 20 calls): " + ", ".join(
        f"{k} {v:.4f} ms" if v == v else f"{k} not measured" for k, v in split.items()))
    d1, d2 = mixed_radix_digits(ids.long(), (t1, t2))
    cols = 4 * (d1.unique().numel() * r * q1 + d2.unique().numel() * r * q2)
    table = torch.cat([G.kron_gather(ef, part, P, True) for part in torch.split(
        torch.arange(V, device=dev, dtype=torch.int32), 8192)]).requires_grad_(True)
    ids_long = ids.long()

    def embedding_fwd_bwd():
        table.grad = None
        F.embedding(ids_long, table).backward(g)

    b_ms, b_by = bound(4 * N + cols + 4 * N * P + 8 * N * r, 2.0 * N * r * (P + q1 + q2))
    results.append({
        "name": "kron_gather_fwd_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/kron_gather.cu",
        "replaces": "src/repro/kernels/kron_gather/kron_gather.py:57",
        "shape": f"ids ({N},) -> ({N}, {P}) + stats ({N}, 2, {r})",
        "max_abs_err": max(err_out, err_stats),
        "ms": time_ms(torch, lambda: G.kron_gather_cuda(ef, ids, P, True, with_stats=True),
                      flush),
        "plain_ms": time_ms(torch, lambda: G.kron_gather_fwd_ref(ef, ids, embed_dim=P),
                            flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, lambda: F.embedding(ids_long, table), flush),
        "library": "F.embedding on the materialized 1.24 GB table",
    })
    # g, the stats and the touched columns in; dF (4.8 MB) out
    b_ms, b_by = bound(4 * N + 4 * N * P + 8 * N * r + cols + fbytes,
                       2.0 * N * r * (2 * P + 4 * (q1 + q2)))
    results.append({
        "name": "kron_gather_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/kron_gather.cu",
        "replaces": "src/repro/kernels/kron_gather/kron_gather.py:80",
        "shape": f"g ({N}, {P}) -> dF1 {tuple(ef[0].shape)}, dF2 {tuple(ef[1].shape)}",
        "max_abs_err": err_bwd,
        "ms": time_ms(torch, lambda: G.kron_gather_bwd_cuda(ef, ids, g, stats), flush),
        "plain_ms": time_ms(torch, lambda: G.kron_gather_bwd_ref(ef, ids, g, want_stats),
                            flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, embedding_fwd_bwd, flush),
        "library": "F.embedding forward + backward on the materialized 1.24 GB table",
    })
    del table, g, dfs, want_dfs, out, want_out
    torch.cuda.empty_cache()

    h = torch.randn((N, P), generator=gen, device=dev)
    y = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
    y[0], y[-1] = 0, V - 1
    tile = cfg.head_vocab_tile
    log(f"[kernels] kron_ce forward and backward: N={N} tokens, F1 {tuple(hf[0].shape)}, "
        f"F2 {tuple(hf[1].shape)} fp32, vocab {V} (of {t1 * t2} columns), "
        f"{CE.vocab_splits(N, t1, torch.cuda.get_device_properties(dev).multi_processor_count)}"
        f" t1 splits; plain version in tiles of {tile} t1 columns")
    fwd_route = CE.fwd_route(r, q1, q2, t2)
    routes = dict(CE.routes)
    loss, m, l = CE.kron_ce_fwd_cuda(hf, h, y, V)
    torch.cuda.synchronize()
    if fwd_route != "kron_ce_fwd_tc" or CE.routes != {**routes, fwd_route: routes[fwd_route] + 1}:
        fail(f"CE forward: route {fwd_route}, counts {CE.routes} (before {routes}); the head "
             f"should take the tensor-core kernel")
    log(f"  CE forward on {fwd_route}: 64-token blocks x "
        f"{CE.bwd_vocab_splits(N, t1, torch.cuda.get_device_properties(dev).multi_processor_count)}"
        f" t1 splits, 3xTF32 wgmma (the backward's pass 1)")
    want = CE.kron_ce_fwd_ref(hf, h, y, V, tile)
    err_fwd = max_err(torch, loss, want[0], CE_LOSS_TOL, "CE forward loss")
    max_err(torch, m, want[1], CE_LOSS_TOL, "CE forward m")
    max_err(torch, l, want[2], dict(atol=0.0, rtol=1e-4), "CE forward l")
    # against a float64 forward: no further than 4x the fp32 plain version's
    # error, or 1e-5 of the largest loss (the card tests' criterion)
    exact = CE.kron_ce_fwd_ref([f.double() for f in hf], h.double(), y, V, tile)[0]
    err64 = (loss.double() - exact).abs().max().item()
    err64_plain = (want[0].double() - exact).abs().max().item()
    limit64 = max(4 * err64_plain, 1e-5 * exact.abs().max().item())
    log(f"  CE forward loss against float64: kernel {err64:.3e}, fp32 plain {err64_plain:.3e}, "
        f"limit {limit64:.3e} ({err64 / limit64:.2f} of it)")
    if not err64 <= limit64:
        fail("CE forward: the losses are further from a float64 forward than the criterion")
    again = CE.kron_ce_fwd_cuda(hf, h, y, V)
    if not all(torch.equal(a, b) for a, b in zip(again, (loss, m, l))):
        fail("the CE forward gave other bits on a second run")
    del exact, again
    gce = torch.full((N,), 1.0 / N, device=dev)
    route = CE.bwd_route(r, q1, q2, t2)
    routes = dict(CE.routes)
    dfs, dh = CE.kron_ce_bwd_cuda(hf, h, y, m, l, gce, V)
    torch.cuda.synchronize()
    if route != "kron_ce_bwd_tc" or CE.routes != {**routes, route: routes[route] + 1}:
        fail(f"CE backward: route {route}, counts {CE.routes} (before {routes}); the "
             f"head should take the tensor-core kernel")
    splits = CE.bwd_vocab_splits(N, t1, torch.cuda.get_device_properties(dev)
                                 .multi_processor_count)
    log(f"  CE backward on {route}: 64-token blocks x {splits} t1 splits, 3xTF32 wgmma")
    want_dfs, want_dh = CE.kron_ce_bwd_ref(hf, h, y, m, l, gce, V, tile)
    err_bwd = max(scaled(a, b, CE_BWD_SCALE, f"CE backward {name}") for name, a, b in
                  zip(("dh", "dF1", "dF2"), (dh, *dfs), (want_dh, *want_dfs)))
    again = CE.kron_ce_bwd_cuda(hf, h, y, m, l, gce, V)
    if not (torch.equal(again[1], dh) and all(torch.equal(a, b)
                                              for a, b in zip(again[0], dfs))):
        fail("the CE backward gave other bits on a second run")
    del again, want_dfs, want_dh
    head = M.kron_matmul(hf, torch.eye(P, device=dev), V).requires_grad_(True)  # (P, V)
    hq = h.clone().requires_grad_(True)
    yl = y.long()

    def dense_ce():
        return F.cross_entropy(torch.matmul(h, head), yl, reduction="none")

    def dense_ce_fwd_bwd():
        hq.grad = head.grad = None
        F.cross_entropy(torch.matmul(hq, head), yl).backward()

    hbytes = 4 * sum(f.numel() for f in hf)
    st1, st2 = 2.0 * r * q1 * q2 * t1, 2.0 * r * q2 * t1 * t2  # per token
    b_ms, b_by = bound(4 * N * P + 4 * N + hbytes + 12 * N, N * (st1 + st2))
    with torch.no_grad():
        lib_fwd = time_ms(torch, dense_ce, flush, iters=10)
    # the same operations at the TF32 tensor cores' rate, as the backward's
    # row counts them: one pass, and the three passes of the 3xTF32 split
    tf32_fwd_ms = N * (st1 + st2) / PEAK_TF32_FLOPS * 1e3
    results.append({
        "name": "kron_ce_fwd", "route": "cuda", "ops_route": fwd_route,
        "source": "src/repro_torch/csrc/kron_logits.cu",
        "replaces": "src/repro/kernels/kron_logits/kron_logits.py:41",
        "shape": f"h ({N}, {P}), labels ({N},) -> loss, m, l ({N},)",
        "max_abs_err": err_fwd,
        "ms": time_ms(torch, lambda: CE.kron_ce_fwd_cuda(hf, h, y, V), flush, iters=10),
        "simt_ms": time_ms(torch, lambda: CE.kron_ce_fwd_cuda(hf, h, y, V,
                                                             route="kron_ce_fwd_simt"),
                           flush, iters=10),
        "plain_ms": time_ms(torch, lambda: CE.kron_ce_fwd_ref(hf, h, y, V, tile), flush,
                            iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_tf32_ms": tf32_fwd_ms, "bound_3xtf32_ms": 3 * tf32_fwd_ms,
        "float64_err": err64, "float64_limit": limit64, "library_ms": lib_fwd,
        "library": "torch.matmul on the materialized (2048, 151936) head + F.cross_entropy",
    })
    # recomputed stages 1 and 2, then dz, dF2 (stage-2 size) and dx, dF1
    # (stage-1 size)
    b_ms, b_by = bound(4 * N * P + 16 * N + hbytes + 4 * N * P + hbytes,
                       N * (3 * st1 + 3 * st2))
    # the same operations at the TF32 tensor cores' rate: one pass, and the
    # three passes of the 3xTF32 split
    tf32_ms = N * (3 * st1 + 3 * st2) / PEAK_TF32_FLOPS * 1e3
    results.append({
        "name": "kron_ce_bwd", "route": "cuda", "ops_route": route,
        "source": "src/repro_torch/csrc/kron_logits.cu",
        "replaces": "src/repro/kernels/kron_logits/kron_logits.py:78",
        "shape": f"h ({N}, {P}), labels, g, m, l ({N},) -> dh ({N}, {P}), dF1, dF2",
        "max_abs_err": err_bwd,
        "ms": time_ms(torch, lambda: CE.kron_ce_bwd_cuda(hf, h, y, m, l, gce, V), flush,
                      iters=10),
        "plain_ms": time_ms(torch, lambda: CE.kron_ce_bwd_ref(hf, h, y, m, l, gce, V, tile),
                            flush, iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_tf32_ms": tf32_ms, "bound_3xtf32_ms": 3 * tf32_ms,
        "library_ms": time_ms(torch, dense_ce_fwd_bwd, flush, iters=10),
        "library": "torch.matmul + F.cross_entropy on the materialized head, "
                   "forward + backward",
    })
    del head, hq, scratch
    torch.cuda.empty_cache()
    for e in results:
        tf32 = (f" (TF32 one pass {e['bound_tf32_ms']:.4f} ms, 3xTF32 "
                f"{e['bound_3xtf32_ms']:.4f} ms)" if "bound_tf32_ms" in e else "")
        simt = f"  CUDA-core kernel {e['simt_ms']:.4f} ms" if "simt_ms" in e else ""
        log(f"  {e['name']:22s} kernel {e['ms']:.4f} ms  bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}){tf32}{simt}  plain {e['plain_ms']:.4f} ms  library "
            f"{e['library_ms']:.4f} ms")
    return results


def kernel_times(torch, fn, names: dict, calls: int = 20) -> dict:
    """Mean device time per call of each kernel that ``fn`` launches, by
    torch.profiler over ``calls`` calls after a warm-up: {label: ms} for
    ``names`` ({label: substring of the kernel's name}); "not measured" when
    the trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for label, key in names.items():
        us = sum((getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CUDA and key in e.key)
        out[label] = us / 1e3 / calls if us > 0 else float("nan")
    return out


def drive_training(torch, dev, cfg, tag: str):
    """Phases 7 and 8: ``cfg`` training through make_train_step, launch
    counts checked per leg; returns the launches and the training state (for
    the fp32 check)."""
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.kernels.kron_logits import ops as CE
    from repro_torch.kernels.kron_matmul import ops as M
    from repro_torch.models import model as MD
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainConfig, make_train_step, with_params

    batch = TRAIN_TOKENS // TRAIN_SEQ
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=batch,
                      seed=0)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR))
    torch.cuda.reset_peak_memory_stats()
    state = with_params(MD.init_params(cfg, seed=0, device=dev))
    step_fn = make_train_step(cfg, tcfg)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in batch_at(dcfg, i).items()}
               for i in range(TRAIN_STEPS + 1)]
    ket_rank = f" at rank {cfg.linear_rank}" if cfg.linear_kind == "ket" else ""
    log(f"[{tag}] {cfg.name}, {cfg.linear_kind} linears{ket_rank}: "
        f"{MD.param_count(state['params']):,} params; {TRAIN_STEPS} AdamW steps at lr "
        f"{TRAIN_LR:g} (constant, no warmup), batch {batch} x seq {TRAIN_SEQ} synthetic "
        f"Markov tokens, activations {cfg.dtype}, remat {cfg.remat!r}")
    torch.cuda.synchronize()
    reset_counts()
    losses, gnorms, walls = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        losses.append(float(metrics["loss"]))  # a host read: the step has ended
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(metrics["grad_norm"]))
        log(f"[{tag}] step {i}: loss {losses[-1]:.4f}, grad norm {gnorms[-1]:.4f}, "
            f"{walls[-1]:.1f} ms")
    launches = {**G.launches, **CE.launches, **M.launches,
                **{k: FA.launches[k] for k in FLASH_KERNELS}}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # a ket layer runs 7 projections forward, again in its recompute, and
    # one backward each
    ket = 7 * cfg.num_layers if cfg.linear_kind == "ket" else 0
    S = TRAIN_STEPS
    expected = {"kron_gather_fwd": 0, "kron_gather_fwd_stats": S, "kron_gather_bwd": S,
                "kron_gather_fwd_quant": 0, "kron_ce_fwd": S, "kron_ce_bwd": S,
                "kron_matmul_fwd": 2 * ket * S, "kron_matmul_bwd": ket * S,
                "kron_matmul_fwd_quant": 0, "flash_fwd": 0,
                "flash_fwd_tc": 2 * cfg.num_layers * S}
    log(f"[{tag}] launches {launches} (expected {expected}: one per training leg per "
        f"step; per ket projection per step two forwards and one backward; per layer "
        f"per step two bf16 flash forwards on the tensor cores, the second in the "
        f"recompute)")
    if launches != expected:
        fail(f"{tag}: launches {launches}, expected {expected}")
    want_routes = {"kron_ce_bwd_tc": S, "kron_ce_bwd_simt": 0, "kron_ce_fwd_tc": S,
                   "kron_ce_fwd_simt": 0}
    log(f"[{tag}] CE routes {CE.routes} (expected {want_routes}: the head takes the "
        f"tensor-core kernels)")
    if CE.routes != want_routes:
        fail(f"{tag}: CE routes {CE.routes}, expected {want_routes}")
    if not all(math.isfinite(v) for v in losses + gnorms):
        fail(f"{tag}: non-finite training metrics: losses {losses}, grad norms {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the loss did not fall: {losses}")
    steady = statistics.median(walls[1:])
    log(f"[{tag}] loss {losses[0]:.4f} -> {losses[-1]:.4f}; step wall median "
        f"{steady:.1f} ms over steps 1-{TRAIN_STEPS - 1} ({TRAIN_TOKENS / steady * 1e3:.0f} "
        f"tokens/s); peak device memory {peak:.2f} GiB")
    profile_call(torch, f"one {tag} step", lambda: step_fn(state, batches[TRAIN_STEPS]),
                 steady, groups={**FLASH_GROUPS,
                                 "kron_matmul kernels": ["kron_stage", "kron_gemm",
                                                         "kron_sum_parts"],
                                 "CE kernels": ["ce_fwd_kernel", "ce_fwd_tc_kernel",
                                                "ce_bwd_kernel", "ce_combine", "sum_parts",
                                                "ce_bwd_tc_kernel", "prep_f2_kernel",
                                                "transpose_x_kernel", "df2_reduce",
                                                "dx_reduce"],
                                 "kron_gather kernels": ["kron_gather2",
                                                         "transpose_factors"],
                                 "GEMMs": ["gemm", "nvjet", "xmma", "cutlass"],
                                 "elementwise and copies": ["elementwise", "copy", "reduce"]})
    return launches, state


def check_train_step_fp32(torch, dev, state, cfg, plain, tag: str):
    """One full-width fp32 training step through the kernels (``cfg``)
    against the plain versions (``plain``), on the same parameters and
    batch: the loss, the embedding, head and layer-0 gradients, and layer
    0 after one AdamW update."""
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.models import model as MD
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                                         tree_leaves)

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(DataConfig(
        vocab_size=cfg32.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_TOKENS // TRAIN_SEQ, seed=1), 0).items()}
    params = state["params"]
    leaves = list(tree_leaves(params))
    layer = params["layers"][0]
    n_layer = len(list(tree_leaves(layer)))
    first = len(list(tree_leaves(params["embed"])))  # layer 0's leaves follow the embedding
    out = {}
    for name, c in (("kernels", cfg32), ("plain", dataclasses.replace(plain,
                                                                      dtype=torch.float32))):
        before = {k: FA.launches[k] for k in FLASH_KERNELS}
        loss, _ = MD.loss_fn(params, c, batch)
        grads = torch.autograd.grad(loss, leaves)
        ran = {k: FA.launches[k] - before[k] for k in FLASH_KERNELS}
        # fp32: the CUDA-core kernel, each layer's forward and its recompute
        want = {"flash_fwd": 2 * cfg.num_layers if name == "kernels" else 0, "flash_fwd_tc": 0}
        if ran != want:
            fail(f"{tag}: the fp32 step ({name}) launched {ran}, expected {want}")
        gnorm = global_norm(grads)
        # one AdamW step of layer 0 from a fresh optimizer state, scaled by
        # this route's global norm, as the full step would apply it
        with torch.no_grad():
            w = [t.detach().clone() for t in tree_leaves(layer)]
        opt = adamw_init(w)
        g0 = list(grads[first:first + n_layer])
        adamw_update(AdamWConfig(lr=TRAIN_LR), g0, opt, w, gnorm=gnorm)
        out[name] = (loss.detach(), {"embed": grads[:2], "head": grads[-2:], "layer 0": g0},
                     w)
        del grads
    (lk, gk, wk), (lp, gp, wp) = out["kernels"], out["plain"]
    dl = abs(lk.item() - lp.item())
    log(f"[{tag}] fp32 step, kernel route vs plain: loss {lk.item():.6f} vs "
        f"{lp.item():.6f}, |dloss| {dl:.3e} (atol {TRAIN_F32_LOSS_ATOL:g})")
    if not dl <= TRAIN_F32_LOSS_ATOL:
        fail(f"{tag}: the fp32 training step's loss disagrees between the routes")
    for part in ("embed", "head"):
        for j, (a, b) in enumerate(zip(gk[part], gp[part])):
            max_err(torch, a, b, dict(atol=TRAIN_F32_GRAD_SCALE * b.abs().max().item(),
                                      rtol=1e-3), f"fp32 step d{part} factor {j + 1}")
    err0 = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
               for a, b in zip(gk["layer 0"], gp["layer 0"]))
    log(f"  fp32 step layer 0 gradients: max |kernel - plain| / max |plain| = {err0:.3e} "
        f"over {n_layer} tensors (bound {TRAIN_F32_GRAD_SCALE:g})")
    if not err0 <= TRAIN_F32_GRAD_SCALE:
        fail(f"{tag}: the fp32 step's layer-0 gradients disagree between the routes")
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(wk, wp)])
    off = (diff > 1e-5).float().mean().item()
    log(f"[{tag}] fp32 step, layer 0 weights after AdamW: max |dw| {diff.max().item():.3e} "
        f"(bound 2 lr = {2 * TRAIN_LR:g}), share above 1e-5: {off:.2e} (bound 1e-3)")
    if diff.max().item() > 2 * TRAIN_LR or off >= 1e-3:
        fail(f"{tag}: the fp32 training step's layer weights disagree between the routes")


def ket_config():
    from repro_torch.configs import get_config
    return get_config(ARCH, linear_kind="ket", linear_rank=KET_RANK)


def check_ket_kernels(torch, dev):
    """Phase 6: the kron_matmul forward and backward at the four ket-linear
    shapes against their plain versions, timed beside their bounds, the
    plain versions and torch.matmul on the materialized weight. Returns the
    JSON row of the backward, summed over one layer's seven projections."""
    from repro_torch.models.common import linear_init
    from repro_torch.kernels.kron_matmul import ops as M

    N = TRAIN_TOKENS
    gen = torch.Generator(device=dev).manual_seed(8)
    scratch = torch.empty(16 * 2 ** 20, dtype=torch.int32, device=dev)  # 64 MB > L2
    flush = scratch.zero_
    sums = {leg: dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms"), 0.0)
            for leg in ("fwd", "bwd", "fwd8")}
    bound_by = {leg: {"bytes": 0.0, "operations": 0.0} for leg in sums}
    bwd_err = 0.0
    for name, d_in, d_out, mult in KET_SHAPES:
        f = linear_init(gen, d_in, d_out, device=dev, kind="ket", rank=KET_RANK)["factors"]
        (r, q1, t1), (_, q2, t2) = f[0].shape, f[1].shape
        log(f"[kernels] ket {name}: {d_in} -> {d_out}, F1 {tuple(f[0].shape)}, "
            f"F2 {tuple(f[1].shape)} fp32, {mult} per layer")
        x = torch.randn((N, d_in), generator=gen, device=dev)
        g = torch.randn((N, d_out), generator=gen, device=dev)
        got = M.kron_matmul(f, x, d_out)
        torch.cuda.synchronize()
        max_err(torch, got, M.kron_matmul(f, x, d_out, use_kernel=False), MATMUL_TOL,
                f"forward B={N}")
        x8 = x[:BATCH].contiguous()
        got = M.kron_matmul(f, x8, d_out)
        torch.cuda.synchronize()
        max_err(torch, got, M.kron_matmul(f, x8, d_out, use_kernel=False), MATMUL_TOL,
                f"forward B={BATCH}")
        dx, dfs = M.kron_matmul_bwd_cuda(f, x, g)
        torch.cuda.synchronize()
        want_dx, want_dfs = M.kron_matmul_bwd_ref(f, x, g)
        for part, a, b in zip(("dx", "dF1", "dF2"), (dx, *dfs), (want_dx, *want_dfs)):
            bwd_err = max(bwd_err, max_err(torch, a, b, dict(
                atol=MATMUL_BWD_SCALE * b.abs().max().item(), rtol=1e-4), f"backward {part}"))
        again = M.kron_matmul_bwd_cuda(f, x, g)
        if not (torch.equal(again[0], dx) and all(torch.equal(a, b)
                                                  for a, b in zip(again[1], dfs))):
            fail(f"the kron_matmul backward gave other bits on a second run ({name})")
        log("  backward: the same bits on a second run")
        del again, want_dx, want_dfs, dx, dfs
        w = M.kron_matmul(f, torch.eye(d_in, device=dev), d_out)  # (d_in, d_out)
        wq, xq = w.clone().requires_grad_(True), x.clone().requires_grad_(True)

        def dense_fwd_bwd():
            wq.grad = xq.grad = None
            torch.matmul(xq, wq).backward(g)

        s1, s2 = 2.0 * r * t1 * q1 * q2, 2.0 * r * q2 * t1 * t2  # per token
        fbytes = 4 * sum(a.numel() for a in f)
        legs = {
            # x and the factors in, y out; x, g and the factors in, dx and dF out
            "fwd": (bound(4 * N * (d_in + d_out) + fbytes, N * (s1 + s2)),
                    lambda: M.kron_matmul(f, x, d_out),
                    lambda: M.kron_matmul(f, x, d_out, use_kernel=False),
                    lambda: torch.matmul(x, w)),
            "bwd": (bound(4 * N * (2 * d_in + d_out) + 2 * fbytes, N * (3 * s1 + 2 * s2)),
                    lambda: M.kron_matmul_bwd_cuda(f, x, g),
                    lambda: M.kron_matmul_bwd_ref(f, x, g), dense_fwd_bwd),
            "fwd8": (bound(4 * BATCH * (d_in + d_out) + fbytes, BATCH * (s1 + s2)),
                     lambda: M.kron_matmul(f, x8, d_out),
                     lambda: M.kron_matmul(f, x8, d_out, use_kernel=False),
                     lambda: torch.matmul(x8, w)),
        }
        for leg, ((b_ms, b_by), kern, plain, lib) in legs.items():
            iters = 50 if leg == "fwd8" else 20
            t = {"ms": time_ms(torch, kern, flush, iters=iters),
                 "plain_ms": time_ms(torch, plain, flush, iters=iters),
                 "bound_ms": b_ms, "library_ms": time_ms(torch, lib, flush, iters=iters)}
            log(f"  {leg:4s} kernel {t['ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})  plain "
                f"{t['plain_ms']:.4f} ms  library {t['library_ms']:.4f} ms")
            for k, v in t.items():
                sums[leg][k] += mult * v
            bound_by[leg][b_by] += mult * b_ms
        del w, wq, xq, x, g
        torch.cuda.empty_cache()
    del scratch
    torch.cuda.empty_cache()
    for leg, t in sums.items():
        tokens = BATCH if leg == "fwd8" else N
        log(f"  one layer's 7 ket projections, {leg} at {tokens} tokens: kernel "
            f"{t['ms']:.4f} ms  bound {t['bound_ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library {t['library_ms']:.4f} ms")
    return [{
        "name": "kron_matmul_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/kron_matmul.cu",
        "replaces": "src/repro/kernels/kron_matmul/kron_matmul.py:70",
        "shape": f"one layer's 7 ket projections (rank {KET_RANK}) at {N} tokens",
        "max_abs_err": bwd_err, **sums["bwd"],
        # the layer's bound is the sum of its calls' bounds; name the larger share
        "bound_by": max(bound_by["bwd"], key=bound_by["bwd"].get),
        "library": "torch.matmul forward + backward on the materialized weights",
    }]


def ket_stored_bytes(params) -> dict:
    """Bytes held by the ket factor stacks of ``params`` (payloads and
    scales, or fp32 factors): the embedding, the head, the ket linears."""
    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(nbytes(v) for v in tree)
        return tree.numel() * tree.element_size()

    def factors(tree):
        if isinstance(tree, dict):
            if "factors" in tree:
                return nbytes(tree["factors"])
            return sum(factors(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(factors(v) for v in tree)
        return 0

    return {"embedding": factors(params["embed"]), "head": factors(params["head"]),
            "ket linears": factors(params["layers"])}


def check_quant_kernels(torch, dev):
    """Phase 10: the dequant-fused legs (slice 5) at full width in int8 and
    fp8, each against its plain version, timed beside its bound, its fp32
    leg on the dequantized factors, the plain version and a yardstick on
    the dequantized materialized table or weight. Returns the JSON rows of
    the int8 decode shapes (8 ids; the head at B = 8)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.configs.base import embedding_for, head_for
    from repro_torch.core import ketops
    from repro_torch.core import quant as Q
    from repro_torch.core.kron import mixed_radix_digits
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.kernels.kron_matmul import ops as M
    from repro_torch.models.common import linear_init

    cfg = get_config(ARCH)
    espec, hspec = embedding_for(cfg).spec, head_for(cfg).spec
    gen = torch.Generator(device=dev).manual_seed(10)
    ef32 = ketops.init(gen, espec, dev)["factors"]
    hf32 = ketops.init(gen, hspec, dev)["factors"]
    r, (q1, q2), (t1, t2) = espec.rank, espec.resolved_q(), espec.resolved_t()
    P, V = espec.in_dim, cfg.vocab_size
    scratch = torch.empty(16 * 2 ** 20, dtype=torch.int32, device=dev)  # 64 MB > L2
    flush = scratch.zero_
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results, ket_sums = [], {}

    def timed(entry, kern, plain, fp32, lib, iters=50):
        # at least 20 timed calls of the kernels; ``iters`` of the plain version
        entry.update(ms=time_ms(torch, kern, flush, iters=max(iters, 20)),
                     plain_ms=time_ms(torch, plain, flush, iters=iters),
                     fp32_ms=time_ms(torch, fp32, flush, iters=max(iters, 20)),
                     library_ms=time_ms(torch, lib, flush, iters=max(iters, 20)))
        return entry

    def split(fq):
        return [f["q"] for f in fq], [f["scale"] for f in fq], [Q.as_f32(f) for f in fq]

    for mode in ("int8", "fp8"):
        ep, es, edq = split([Q.quantize(f, mode) for f in ef32])
        log(f"[kernels] kron_gather_fwd_quant ({mode}): payloads {tuple(ep[0].shape)}, "
            f"{tuple(ep[1].shape)} {ep[0].dtype}, fp32 ({r}, 1, 1) scales, LN on, out (N, {P})")
        table = torch.cat([G.kron_gather(edq, part, P, True) for part in torch.split(
            torch.arange(V, device=dev, dtype=torch.int32), 8192)])
        for n in (BATCH, BATCH * cfg.prefill_chunk, LOOKUP_LONG):
            ids = torch.randint(0, V, (n,), generator=gen, device=dev, dtype=torch.int32)
            ids[0], ids[-1] = 0, V - 1
            got = G.kron_gather_quant(ep, es, ids, P, True)
            torch.cuda.synchronize()
            def plain(part):
                return G.kron_gather_quant(ep, es, part, P, True, use_kernel=False)

            err = max_err(torch, got, chunked(torch, plain, ids), GATHER_TOL, f"{mode} N={n}")
            # the fp32 leg on the dequantized stacks (q.float() * scale) gives the same bits
            if not torch.equal(got, G.kron_gather(edq, ids, P, True)):
                fail(f"kron_gather_fwd_quant ({mode}) N={n}: other bits than the fp32 leg on "
                     f"the dequantized stacks")
            log(f"  {mode} N={n}: strided, {G.lookup_bands(n, q1, sms)} block(s) per id; the "
                f"fp32 leg on the dequantized stacks ({G.lookup_route(n)!r}) gives the same bits")
            del got
            d1, d2 = mixed_radix_digits(ids.long(), (t1, t2))
            cols = d1.unique().numel() * r * q1 + d2.unique().numel() * r * q2  # 1 B each
            b_ms, b_by = bound(4 * n + cols + 8 * r + 4 * n * P, 2.0 * n * r * (P + q1 + q2))
            ids_long = ids.long()
            results.append(timed({
                "name": "kron_gather_fwd_quant", "route": "cuda", "mode": mode,
                "source": "src/repro_torch/csrc/kron_gather.cu",
                "replaces": "src/repro/kernels/kron_gather/kron_gather.py:57",
                "shape": f"ids ({n},) -> ({n}, {P})", "max_abs_err": err,
                "bands": G.lookup_bands(n, q1, sms), "bound_ms": b_ms, "bound_by": b_by,
                "library": "F.embedding on the dequantized materialized 1.24 GB table"},
                lambda: G.kron_gather_quant(ep, es, ids, P, True),
                lambda: chunked(torch, plain, ids),
                lambda: G.kron_gather(edq, ids, P, True),
                lambda: F.embedding(ids_long, table), iters=5 if n == LOOKUP_LONG else 50))
        del table

        hp, hs, hdq = split([Q.quantize(f, mode) for f in hf32])
        log(f"[kernels] kron_matmul_fwd_quant ({mode}): the head, payloads "
            f"{tuple(hp[0].shape)}, {tuple(hp[1].shape)}, out (B, {V})")
        head = M.kron_matmul(hdq, torch.eye(P, device=dev), V)  # (P, V) dequantized
        for b in (BATCH, 1):
            x = torch.randn((b, P), generator=gen, device=dev)
            got = M.kron_matmul_quant(hp, hs, x, V)
            torch.cuda.synchronize()
            err = max_err(torch, got, M.kron_matmul_quant(hp, hs, x, V, use_kernel=False),
                          MATMUL_TOL, f"{mode} head B={b}")
            flops = 2.0 * b * (r * t1 * q1 * q2 + r * q2 * t1 * t2)
            b_ms, b_by = bound(4 * b * P + sum(f.numel() for f in hp) + 8 * r + 4 * b * V,
                               flops)
            results.append(timed({
                "name": "kron_matmul_fwd_quant", "route": "cuda", "mode": mode,
                "source": "src/repro_torch/csrc/kron_matmul.cu",
                "replaces": "src/repro/kernels/kron_matmul/kron_matmul.py:54",
                "shape": f"x ({b}, {P}) -> ({b}, {V})", "max_abs_err": err,
                "bound_ms": b_ms, "bound_by": b_by,
                "library": "torch.matmul on the dequantized materialized head"},
                lambda: M.kron_matmul_quant(hp, hs, x, V),
                lambda: M.kron_matmul_quant(hp, hs, x, V, use_kernel=False),
                lambda: M.kron_matmul(hdq, x, V), lambda: torch.matmul(x, head)))
        del head

        for name, d_in, d_out, mult in KET_SHAPES:
            fp, fs, fdq = split(linear_init(gen, d_in, d_out, device=dev, kind="ket",
                                            rank=KET_RANK, quant=mode)["factors"])
            (rk, a1, b1), (_, a2, b2) = fp[0].shape, fp[1].shape
            w = M.kron_matmul(fdq, torch.eye(d_in, device=dev), d_out)  # dequantized weight
            for b in (BATCH, BATCH * cfg.prefill_chunk):
                x = torch.randn((b, d_in), generator=gen, device=dev)
                got = M.kron_matmul_quant(fp, fs, x, d_out)
                torch.cuda.synchronize()
                err = max_err(torch, got, M.kron_matmul_quant(fp, fs, x, d_out,
                                                              use_kernel=False),
                              MATMUL_TOL, f"{mode} ket {name} B={b}")
                b_ms, b_by = bound(4 * b * (d_in + d_out) + sum(f.numel() for f in fp)
                                   + 8 * rk, 2.0 * b * (rk * b1 * a1 * a2 + rk * a2 * b1 * b2))
                e = timed({"bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err},
                          lambda: M.kron_matmul_quant(fp, fs, x, d_out),
                          lambda: M.kron_matmul_quant(fp, fs, x, d_out, use_kernel=False),
                          lambda: M.kron_matmul(fdq, x, d_out), lambda: torch.matmul(x, w),
                          iters=50 if b == BATCH else 20)
                acc = ket_sums.setdefault((mode, b), dict.fromkeys(
                    ("ms", "plain_ms", "fp32_ms", "library_ms", "bound_ms"), 0.0))
                for k in acc:
                    acc[k] += mult * e[k]
            del w
        torch.cuda.empty_cache()
    del scratch
    torch.cuda.empty_cache()
    for e in results:
        log(f"  {e['name']:21s} {e['mode']:4s} {e['shape']:28s} kernel {e['ms']:.4f} ms  "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})  fp32 leg {e['fp32_ms']:.4f} ms  "
            f"plain {e['plain_ms']:.4f} ms  library {e['library_ms']:.4f} ms")
    for (mode, b), t in ket_sums.items():
        log(f"  one layer's 7 ket projections, {mode} at {b} tokens: kernel {t['ms']:.4f} ms  "
            f"bound {t['bound_ms']:.4f} ms  fp32 leg {t['fp32_ms']:.4f} ms  plain "
            f"{t['plain_ms']:.4f} ms  library {t['library_ms']:.4f} ms")
    # the JSON line keeps the engine's mode and decode shapes
    return [e for e in results if e["mode"] == "int8"
            and e["shape"].startswith((f"ids ({BATCH},)", f"x ({BATCH},"))]


def drive_ket_serving(torch, dev, quant: str = "none"):
    """Phase 9: ket serving at full width, launch counts checked, one decode
    step profiled, one fp32 decode step against the plain versions; with
    ``quant`` (phase 11) the same weights quantized, and their stored bytes
    per mode against the specs' count. Returns the greedy tokens."""
    from repro_torch.configs.base import embedding_for, head_for
    from repro_torch.core.embedding import embedding_num_bytes
    from repro_torch.core.logits import head_num_bytes
    from repro_torch.core.quant import quantize_params, storage_bytes
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.kernels.kron_matmul import ops as M
    from repro_torch.models import model as MD

    cfg = ket_config()
    params = MD.init_params(cfg, seed=0, device=dev)
    tag = "ket serve" if quant == "none" else f"ket serve {quant}"
    if quant != "none":
        stored = {}
        for mode in ("none", "int8", "fp8"):
            got = ket_stored_bytes(quantize_params(params, mode))
            # the specs' count: the embedding and head specs, and the ket
            # linears' factor shapes under the mode
            shapes = [tuple(f.shape) for layer in params["layers"]
                      for part in (layer["attn"], layer["ffn"]) for p in part.values()
                      if isinstance(p, dict) and "factors" in p for f in p["factors"]]
            mcfg = dataclasses.replace(cfg, quant=mode)
            want = {"embedding": embedding_num_bytes(embedding_for(mcfg)),
                    "head": head_num_bytes(head_for(mcfg)),
                    "ket linears": storage_bytes(shapes, mode)}
            if got != want:
                fail(f"stored bytes {got} under {mode}, the specs count {want}")
            stored["fp32" if mode == "none" else mode] = got
        for part in stored["fp32"]:
            log(f"[{tag}] stored bytes of the {part}: " + ", ".join(
                f"{mode} {b[part]:,} B" for mode, b in stored.items())
                + f" ({stored['fp32'][part] / stored['int8'][part]:.2f}x less in int8)")
        params = quantize_params(params, quant)
    C = cfg.prefill_chunk
    gen = torch.Generator(device=dev).manual_seed(9)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen,
                            device=dev, dtype=torch.int32)
    lens = torch.full((BATCH,), C, device=dev, dtype=torch.int32)
    log(f"[{tag}] {cfg.name}, ket linears at rank {cfg.linear_rank}: "
        f"{MD.param_count(params):,} stored values; {BATCH} prompts of {PROMPT_LEN} tokens, "
        f"{KET_DECODE_STEPS} decode steps")
    with torch.inference_mode():
        warm = MD.init_cache(cfg, BATCH, MAX_LEN, device=dev)  # first-call set-up
        logits, warm = MD.prefill_chunk_fn(params, cfg, warm, prompts[:, :C], lens)
        MD.serve_step_fn(params, cfg, warm, logits.argmax(-1).to(torch.int32))
        del warm
        cache = MD.init_cache(cfg, BATCH, MAX_LEN, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for c0 in range(0, PROMPT_LEN, C):
            logits, cache = MD.prefill_chunk_fn(params, cfg, cache, prompts[:, c0:c0 + C],
                                                lens)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        tok = logits.argmax(-1).to(torch.int32)
        generated = [tok]
        t0 = time.perf_counter()
        for _ in range(KET_DECODE_STEPS):
            logits, cache = MD.serve_step_fn(params, cfg, cache, tok)
            tok = logits.argmax(-1).to(torch.int32)
            generated.append(tok)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        launches = {**{k: G.launches[k] for k in ("kron_gather_fwd", "kron_gather_fwd_quant")},
                    **M.launches, **{k: FA.launches[k] for k in FLASH_KERNELS}}
    n_chunks = PROMPT_LEN // C
    calls = n_chunks + KET_DECODE_STEPS
    leg = "" if quant == "none" else "_quant"
    expected = {k: 0 for k in launches}
    expected[f"kron_gather_fwd{leg}"] = calls
    expected[f"kron_matmul_fwd{leg}"] = calls * (7 * cfg.num_layers + 1)
    log(f"[{tag}] launches {launches} (expected {expected}: per call one lookup, "
        f"7 ket projections per layer and the head; no flash launch)")
    if launches != expected:
        fail(f"{tag}: launches {launches}, expected {expected}")
    if tuple(logits.shape) != (BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
        fail(f"{tag}: logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    toks = torch.stack(generated)
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{tag}: a generated token lies outside the vocabulary")
    log(f"[{tag}] prefill {BATCH}x{PROMPT_LEN} tokens in {n_chunks} chunks: "
        f"{t_prefill:.3f} s ({BATCH * PROMPT_LEN / t_prefill:.0f} prompt tok/s); decode "
        f"{KET_DECODE_STEPS} steps: {t_decode:.3f} s ({BATCH * KET_DECODE_STEPS / t_decode:.0f}"
        f" gen tok/s, {t_decode / KET_DECODE_STEPS * 1e3:.2f} ms/step); tokens in the "
        f"vocabulary, logits finite")
    with torch.inference_mode():
        profile_call(torch, f"one {tag} decode step", lambda: MD.serve_step_fn(
            params, cfg, cache, tok), t_decode / KET_DECODE_STEPS * 1e3,
            groups={"kron_matmul kernels": ["kron_stage"], "kron_gather kernels":
                    ["kron_gather2"], "GEMMs": ["gemm", "nvjet", "xmma", "cutlass"],
                    "elementwise and copies": ["elementwise", "copy", "reduce"]})
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        outs = []
        for c in (cfg32, dataclasses.replace(cfg32, use_kernels=False,
                                             linear_use_kernel=False)):
            cache32 = MD.init_cache(c, BATCH, 8, device=dev)
            outs.append(MD.serve_step_fn(params, c, cache32, tok)[0])
            del cache32
    diff = (outs[0] - outs[1]).abs().max().item()
    log(f"[{tag}] fp32 decode step, kernel route vs plain: max |dlogit| = {diff:.3e} "
        f"(atol {MODEL_F32_ATOL:g}), |logit| max {outs[1].abs().max().item():.3f}")
    if not diff <= MODEL_F32_ATOL:
        fail(f"{tag}: the kernel route and the plain versions disagree")
    return launches, toks


def drive_prefill(torch, dev):
    """Phase 13: slice 6's path, ``prefill_fn`` on one 32,768-token prompt of
    the full config (bf16), launch counts checked, timed, profiled; then a
    bf16 and an fp32 prefill at 4,096 tokens through the kernels against
    ``use_kernels=False``. Returns the launches of the 32,768-token call and
    of the fp32 one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.kernels.kron_logits import ops as CE
    from repro_torch.kernels.kron_matmul import ops as M
    from repro_torch.models import model as MD

    cfg = get_config(ARCH)
    params = MD.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), generator=gen, device=dev,
                           dtype=torch.int32)
    log(f"[prefill] {cfg.name}: prefill_fn on 1 prompt of {PREFILL_LEN:,} tokens "
        f"(prefill_32k's length, its batch cut from 32 to 1), activations {cfg.dtype}")
    with torch.inference_mode():
        MD.prefill_fn(params, cfg, {"tokens": tokens[:, :1024]})  # first-call set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        x_last, caches = MD.prefill_fn(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**G.launches, **CE.launches, **M.launches, **FA.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {k: 0 for k in launches}
    expected["kron_gather_fwd"] = 1  # the embedding lookup, no grad: the serving leg
    expected["flash_fwd_tc"] = cfg.num_layers
    log(f"[prefill] launches {launches} (expected {expected}: one lookup, one flash "
        f"forward per layer on the tensor cores)")
    if launches != expected:
        fail(f"prefill: launches {launches}, expected {expected}")
    shape = (1, PREFILL_LEN, cfg.num_kv_heads, cfg.head_dim)
    if tuple(x_last.shape) != (1, cfg.d_model) or not torch.isfinite(x_last).all():
        fail(f"prefill: last hidden state {tuple(x_last.shape)}, finite "
             f"{bool(torch.isfinite(x_last).all())}")
    if len(caches) != cfg.num_layers:
        fail(f"prefill: {len(caches)} caches for {cfg.num_layers} layers")
    for i, c in enumerate(caches):
        for name in ("k", "v"):
            t = c[name]
            if tuple(t.shape) != shape or t.dtype != cfg.dtype or not torch.isfinite(t).all():
                fail(f"prefill: layer {i} {name} {tuple(t.shape)} {t.dtype}, finite "
                     f"{bool(torch.isfinite(t).all())}; expected {shape} {cfg.dtype}")
    log(f"[prefill] {PREFILL_LEN:,} tokens in {wall:.3f} s ({PREFILL_LEN / wall:.0f} prompt "
        f"tok/s); peak device memory {peak:.2f} GiB; {len(caches)} caches of k and v "
        f"{shape} {cfg.dtype}, all finite; last hidden state finite")
    del caches, x_last
    with torch.inference_mode():
        profile_call(torch, f"one {PREFILL_LEN:,}-token prefill_fn", lambda: MD.prefill_fn(
            params, cfg, {"tokens": tokens}), wall * 1e3,
            groups={**FLASH_GROUPS, "kron_gather kernels":
                    ["kron_gather2"], "GEMMs": ["gemm", "nvjet", "xmma", "cutlass"],
                    "elementwise and copies": ["elementwise", "copy", "reduce"]})
    torch.cuda.empty_cache()

    def both_routes(c, n):
        """prefill_fn of tokens[:, :n] through the kernels and through
        use_kernels=False, with the flash launches of each."""
        outs, ran = [], []
        with torch.inference_mode():
            for route in (c, dataclasses.replace(c, use_kernels=False)):
                before = {k: FA.launches[k] for k in FLASH_KERNELS}
                outs.append(MD.prefill_fn(params, route, {"tokens": tokens[:, :n]}))
                ran.append({k: FA.launches[k] - before[k] for k in FLASH_KERNELS})
        return outs, ran

    # bf16 at 4,096 tokens, row by row
    outs, ran = both_routes(cfg, PREFILL_BF16_LEN)
    want = [{"flash_fwd": 0, "flash_fwd_tc": cfg.num_layers}, dict.fromkeys(FLASH_KERNELS, 0)]
    if ran != want:
        fail(f"bf16 prefill at {PREFILL_BF16_LEN}: flash launches {ran}, expected {want}")
    (xk, ck), (xp, cp) = outs
    rows = {"last hidden state": (xk, xp)}
    for name in ("k", "v"):
        rows.update({f"layer {i} {name}": (ck[i][name], cp[i][name])
                     for i in range(cfg.num_layers)})
    worst, mids = {}, []
    for what, (a, b) in rows.items():
        rel = (a.float() - b.float()).norm(dim=-1) / b.float().norm(dim=-1).clamp_min(1e-30)
        worst[what] = rel.max().item()
        mids.append(rel.flatten())
    bad = max(worst, key=worst.get)
    mid = torch.cat(mids).median().item()
    log(f"  bf16 prefill at {PREFILL_BF16_LEN} tokens, kernel route vs use_kernels=False, "
        f"per-row relative error: last hidden state {worst['last hidden state']:.3e}, "
        f"layer 1 k {worst['layer 1 k']:.3e} v {worst['layer 1 v']:.3e}, layer "
        f"{cfg.num_layers - 1} k {worst[f'layer {cfg.num_layers - 1} k']:.3e} v "
        f"{worst[f'layer {cfg.num_layers - 1} v']:.3e}; worst {worst[bad]:.3e} ({bad}), "
        f"median over every row {mid:.3e} (limit {PREFILL_BF16_ROW_RTOL:g}) "
        f"{'ok' if worst[bad] <= PREFILL_BF16_ROW_RTOL else 'DISAGREES'}")
    log("  bf16 prefill worst row per layer (k, v): " + ", ".join(
        f"{i}: {worst[f'layer {i} k']:.1e}/{worst[f'layer {i} v']:.1e}"
        for i in range(cfg.num_layers)))
    if not worst[bad] <= PREFILL_BF16_ROW_RTOL:
        fail(f"bf16 prefill at {PREFILL_BF16_LEN} tokens: {bad} is {worst[bad]:.3e} off "
             f"use_kernels=False")
    del outs, ck, cp, xk, xp, rows, mids
    torch.cuda.empty_cache()

    outs, ran = both_routes(dataclasses.replace(cfg, dtype=torch.float32), PREFILL_F32_LEN)
    want = [{"flash_fwd": cfg.num_layers, "flash_fwd_tc": 0}, dict.fromkeys(FLASH_KERNELS, 0)]
    if ran != want:
        fail(f"fp32 prefill at {PREFILL_F32_LEN}: flash launches {ran}, expected {want}")
    (xk, ck), (xp, cp) = outs
    pairs = [("last hidden state", xk, xp)] + [
        (f"layer {i} {name}", ck[i][name], cp[i][name])
        for i in range(cfg.num_layers) for name in ("k", "v")]
    errs = {}
    for what, a, b in pairs:
        errs[what] = (a - b).abs().max().item()
        if not torch.allclose(a, b, **PREFILL_F32_TOL):
            fail(f"fp32 prefill at {PREFILL_F32_LEN} tokens, kernel route vs "
                 f"use_kernels=False, {what}: max |kernel - plain| = {errs[what]:.3e}")
    worst = max(errs, key=errs.get)
    log(f"  fp32 prefill at {PREFILL_F32_LEN} tokens, kernel route vs use_kernels=False: "
        f"the last hidden state and every layer's k and v within atol "
        f"{PREFILL_F32_TOL['atol']:g}, rtol {PREFILL_F32_TOL['rtol']:g}; max |kernel - plain| "
        f"{errs['last hidden state']:.3e} on the hidden state, {errs[worst]:.3e} at most "
        f"({worst}) ok")
    del outs, params
    torch.cuda.empty_cache()
    return launches, ran[0]


def log_flash_build(report: str) -> None:
    """What nvcc's -Xptxas -v says of each flash kernel instance: registers
    at launch and spill bytes. The tensor-core kernel launches 384 threads
    with the registers ptxas gives it; setmaxnreg then takes the producer
    warpgroup to 24 and each consumer warpgroup to 240. Its shared memory
    is all dynamic: the q tile and two (K, V) stages of 128 rows (5 x 128 x
    Dh x 2 bytes), the barriers and 1,024 bytes of alignment."""
    import re

    entry = None
    for line in report.splitlines():
        m = re.search(r"(flash_fwd(?:_tc)?_kernel)I(?:\d+(\w+?))?Li(\d+)E", line)
        if "Compiling entry function" in line and m:
            entry = f"{m.group(1)}<{m.group(2) or 'float'}, {m.group(3)}>"
        elif entry and "spill" in line:
            spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif entry and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            d = int(entry.split(", ")[1][:-1])
            what = (f"{regs} registers at launch (384 threads; setmaxnreg: producer 24, "
                    f"consumers 240), dynamic shared memory {5 * 128 * d * 2 + 40 + 1024:,} B"
                    if "_tc_" in entry else f"{regs} registers (128 threads, 2 blocks per SM)")
            log(f"  flash_attn: {entry}: {what}, {spill} spill bytes")
            entry = None


def agree(what: str, got, want) -> None:
    """Report the share of greedy tokens of a quantized run equal to the
    fp32 run's on the same weights, both (sequences, positions). The
    decodes run free, so a first difference changes the context after it;
    the first position has the same context in both. A report, not a
    gate."""
    same = (got.cpu() == want.cpu()).float()
    log(f"[quant] {what}: {same.mean().item():.1%} of {same.numel()} greedy tokens equal "
        f"the fp32 run's on the same weights; first position {same[:, 0].mean().item():.1%} "
        f"of {same.shape[0]}")


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py; run it from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    # the plain versions' matmuls run on the card in full fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[env] {card}")
    log(f"[env] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    # flash_attn first: its compile time, the longest, is then its own
    reports = build.build_all(["flash_attn", "kron_gather", "kron_matmul", "paged_attention",
                               "kron_logits"])
    log(f"[env] kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for name, out in reports.items():
        for line in out.splitlines():
            if line.startswith("nvcc ") or (name != "flash_attn" and (
                    "registers" in line or "spill" in line)):
                log(f"  {name}: {line.strip()}")
    log_flash_build(reports["flash_attn"])  # its instances, named

    kernels = (check_kernels(torch, dev) + check_paged_kernels(torch, dev)
               + check_training_kernels(torch, dev) + check_ket_kernels(torch, dev)
               + check_quant_kernels(torch, dev) + check_flash_kernels(torch, dev))
    params = init_params(torch, dev)
    launches, main_toks = drive_main_path(torch, dev, params)  # slice 1's path
    engine_launches, engine_outs = drive_engine(torch, dev, params)  # slice 2's, run (a)
    check_paged_step_fp32(torch, dev, params)
    # slice 5's path: the same weights calibrated to int8 by the engine, and
    # to fp8 for the raw steps
    quant_launches, quant_outs = drive_engine(torch, dev, params, quant="int8")
    agree("engine run (a), int8", torch.tensor(quant_outs), torch.tensor(engine_outs))
    fp8_launches, fp8_toks = drive_main_path(torch, dev, params, quant="fp8",
                                             steps=KET_DECODE_STEPS)
    agree("raw steps, fp8", fp8_toks.T, main_toks[:KET_DECODE_STEPS + 1].T)
    del params
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    train_launches, state = drive_training(torch, dev, cfg, "train")  # slice 3's path
    check_train_step_fp32(torch, dev, state, cfg, dataclasses.replace(cfg, use_kernels=False),
                          "train")
    del state
    torch.cuda.empty_cache()
    kcfg = ket_config()
    ket_launches, state = drive_training(torch, dev, kcfg, "ket train")  # slice 4's path
    check_train_step_fp32(torch, dev, state, kcfg, dataclasses.replace(
        kcfg, use_kernels=False, linear_use_kernel=False), "ket train")
    del state
    torch.cuda.empty_cache()
    _, ket_toks = drive_ket_serving(torch, dev)  # slice 4's serving
    ket_quant_launches, ket_quant_toks = drive_ket_serving(torch, dev, quant="int8")
    agree("ket serving, int8", ket_quant_toks.T, ket_toks.T)
    prefill_launches, prefill_f32_launches = drive_prefill(torch, dev)  # slice 6's path
    log(f"[quant] launches of the quantized legs: engine run (a) int8 "
        f"{quant_launches}; raw steps fp8 {fp8_launches}; ket serving int8 "
        f"{ket_quant_launches}")
    # each row's launches come from the path that runs it at that shape
    path_of = {"kron_gather_fwd": launches, "kron_matmul_fwd": launches,
               "paged_split": engine_launches, "paged_combine": engine_launches,
               "kron_gather_fwd_stats": train_launches, "kron_gather_bwd": train_launches,
               "kron_ce_fwd": train_launches, "kron_ce_bwd": train_launches,
               "kron_matmul_bwd": ket_launches,
               "kron_gather_fwd_quant": quant_launches,
               "kron_matmul_fwd_quant": quant_launches,
               "flash_fwd_tc": train_launches, "flash_fwd": prefill_f32_launches}
    for e in kernels:
        e["launches"] = path_of[e["name"]][e["name"]]
        if e["shape"].startswith("prefill"):  # one 32,768-token prefill_fn
            e["launches"] = prefill_launches[e["name"]]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
