#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA card and nvcc, builds the
port's CUDA kernels from src/repro_torch/csrc into build/, and exits
non-zero, printing no result, when anything is missing or any phase fails:

1. environment: the card's name and power limit, torch and CUDA versions,
   the kernel build of the three sources (one nvcc each, in parallel,
   timed, with nvcc's register / shared-memory report);
2. every kernel of the serving paths against its plain PyTorch version at
   the full qwen3-1.7b shapes, with the tolerance stated, and timed with
   CUDA events (device time, L2 flushed before every launch; median of 50)
   beside its bound, the plain version and one PyTorch call as a yardstick
   where one exists: the word2ketXS lookup, the kron head, and the split-KV
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
5. a JSON line of the kernels, then ``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# fp32 FLOP/s on the CUDA cores (both kernels compute in fp32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

ARCH = "qwen3-1.7b"
BATCH, PROMPT_LEN, NEW_TOKENS, MAX_LEN = 8, 128, 32, 512
GATHER_TOL = dict(atol=1e-4, rtol=1e-5)  # sums of 32 unit-variance LN rows;
# the kernel takes the order-2 LN moments by the separable formula
MATMUL_TOL = dict(atol=1e-4, rtol=1e-5)  # depth-(r*q2) fp32 sums, other order
MODEL_F32_ATOL = 1e-3  # 28 random fp32 layers may grow a ~1e-6 embedding difference
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


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want, tol, what: str) -> float:
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, **tol)
    log(f"  {what}: max |kernel - plain| = {err:.3e} "
        f"(atol {tol['atol']:g}, rtol {tol['rtol']:g}) {'ok' if ok else 'DISAGREES'}")
    if not ok:
        fail(f"{what}: kernel disagrees with its plain version")
    return err


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

    log(f"[kernels] kron_gather_fwd: F1 {tuple(ef[0].shape)}, F2 {tuple(ef[1].shape)} fp32, "
        f"LN on, out (N, {P})")
    gathers = {}
    for n in (BATCH * cfg.prefill_chunk, BATCH, 131):
        ids = torch.randint(0, V, (n,), generator=gen, device=dev, dtype=torch.int32)
        ids[0], ids[-1] = 0, V - 1
        got = G.kron_gather(ef, ids, P, True)
        torch.cuda.synchronize()
        want = G.kron_gather(ef, ids, P, True, use_kernel=False)
        gathers[n] = (ids, max_err(torch, got, want, GATHER_TOL, f"N={n}"))
    table = torch.cat([G.kron_gather(ef, part, P, True) for part in
                       torch.split(torch.arange(V, device=dev, dtype=torch.int32), 8192)])
    for n in (BATCH * cfg.prefill_chunk, BATCH):
        ids, err = gathers[n]
        d1, d2 = mixed_radix_digits(ids.long(), (t1, t2))
        cols = d1.unique().numel() * r * q1 + d2.unique().numel() * r * q2
        b_ms, b_by = bound(4 * (n + cols + n * P), 2.0 * n * r * (P + q1 + q2))
        ids_long = ids.long()
        entry = {
            "name": "kron_gather_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/kron_gather.cu",
            "replaces": "src/repro/kernels/kron_gather/kron_gather.py:57",
            "shape": f"ids ({n},) -> ({n}, {P})",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: G.kron_gather(ef, ids, P, True), flush),
            "plain_ms": time_ms(torch, lambda: G.kron_gather(ef, ids, P, True,
                                                             use_kernel=False), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, lambda: torch.nn.functional.embedding(
                ids_long, table), flush),
        }
        results.append(entry)
    del table

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
        log(f"  {e['name']:16s} {e['shape']:34s} kernel {e['ms']:.4f} ms  "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})  plain {e['plain_ms']:.4f} ms  "
            f"library {e['library_ms']:.4f} ms")
    # the JSON line keeps one row per kernel: the decode-step shape, which
    # every decode step gives both kernels (prefill gives kron_matmul the same)
    return [e for e in results
            if e["shape"].startswith((f"ids ({BATCH},)", f"x ({BATCH},"))]


def profile_call(torch, what: str, fn, wall_ms: float) -> None:
    """Device time of one call by kernel (torch.profiler over CUPTI) against
    ``wall_ms``, the call's unprofiled wall time: the device's busy and idle
    share. Prints "not measured" when the trace holds no kernel."""
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


def drive_main_path(torch, dev, params):
    """Phase 3: the full config serving 8 prompts, launch counts checked."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.kernels.kron_matmul import ops as M
    from repro_torch.models import model as MD

    cfg = get_config(ARCH)
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

        G.launches = M.launches = 0
        t0 = time.perf_counter()
        for c0 in range(0, PROMPT_LEN, C):
            logits, cache = MD.prefill_chunk_fn(params, cfg, cache, prompts[:, c0:c0 + C],
                                                lens)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        tok = logits.argmax(-1).to(torch.int32)
        generated = [tok]
        t0 = time.perf_counter()
        for _ in range(NEW_TOKENS):
            logits, cache = MD.serve_step_fn(params, cfg, cache, tok)
            tok = logits.argmax(-1).to(torch.int32)
            generated.append(tok)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        launches = {"kron_gather_fwd": G.launches, "kron_matmul_fwd": M.launches}

    n_chunks = PROMPT_LEN // C
    expected = n_chunks + NEW_TOKENS  # one launch per prefill chunk and per step
    log(f"[main] launches {launches} (expected {expected} each: {n_chunks} prefill "
        f"chunks + {NEW_TOKENS} decode steps)")
    for name, n in launches.items():
        if n != expected:
            fail(f"{name} launched {n} times on the main path, expected {expected}")
    if tuple(logits.shape) != (BATCH, cfg.vocab_size) or logits.dtype != torch.float32:
        fail(f"logits {tuple(logits.shape)} {logits.dtype}, expected ({BATCH}, "
             f"{cfg.vocab_size}) float32")
    if not torch.isfinite(logits).all():
        fail("non-finite logits")
    toks = torch.stack(generated)
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail("a generated token lies outside the vocabulary")
    if not torch.equal(cache["step"], torch.full_like(cache["step"], PROMPT_LEN + NEW_TOKENS)):
        fail(f"cache steps {cache['step'].tolist()}")
    log(f"[main] prefill {BATCH}x{PROMPT_LEN} tokens in {n_chunks} chunks: {t_prefill:.3f} s "
        f"({BATCH * PROMPT_LEN / t_prefill:.0f} prompt tok/s); decode {NEW_TOKENS} steps: "
        f"{t_decode:.3f} s ({BATCH * NEW_TOKENS / t_decode:.0f} gen tok/s, "
        f"{t_decode / NEW_TOKENS * 1e3:.2f} ms/step); tokens in [0, {cfg.vocab_size}), "
        f"logits finite")

    with torch.inference_mode():
        profile_call(torch, "one prefill chunk", lambda: MD.prefill_chunk_fn(
            params, cfg, cache, prompts[:, :C], lens), t_prefill / n_chunks * 1e3)
        profile_call(torch, "one decode step", lambda: MD.serve_step_fn(
            params, cfg, cache, tok), t_decode / NEW_TOKENS * 1e3)

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    outs = []
    with torch.inference_mode():
        for c in (cfg32, dataclasses.replace(cfg32, use_kernels=False)):
            cache32 = MD.init_cache(c, BATCH, 8, device=dev)
            outs.append(MD.serve_step_fn(params, c, cache32, tok)[0])
            del cache32
    diff = (outs[0] - outs[1]).abs().max().item()
    log(f"[main] fp32 decode step, kernel route vs use_kernels=False: max |dlogit| = "
        f"{diff:.3e} (atol {MODEL_F32_ATOL:g}), |logit| max {outs[1].abs().max().item():.3f}")
    if not diff <= MODEL_F32_ATOL:
        fail("the kernel route and the plain versions disagree on the full model")
    return launches


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
    G.launches = M.launches = 0
    FA.launches.update(paged_split=0, paged_combine=0)
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
    launches = {"kron_gather_fwd": G.launches, "kron_matmul_fwd": M.launches,
                "paged_split": FA.launches["paged_split"],
                "paged_combine": FA.launches["paged_combine"]}
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
    expected = {"kron_gather_fwd": st["ticks"], "kron_matmul_fwd": st["ticks"],
                "paged_split": cfg.num_layers * st["decode_ticks"],
                "paged_combine": cfg.num_layers * st["decode_ticks"]}
    log(f"[engine {what}] launches {launches} (expected {expected})")
    if launches != expected:
        fail(f"engine {what}: launches {launches}, expected {expected}")
    if st["completed"] != len(prompts) or st["failed"] or free != cap:
        fail(f"engine {what}: {st['completed']} completed, {st['failed']} failed, "
             f"pages free {free}/{cap}")
    for r in reqs:
        if len(r.output) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in r.output):
            fail(f"engine {what}: request {r.uid} gave {r.output}")
    return eng, st, launches, decode_ms


def drive_engine(torch, dev, params):
    """Phase 4: slice 2's path, ServingEngine at full width, runs (a) and (b)."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import Request
    from repro_torch.serve.faultinject import shared_prefix_prompts

    cfg = get_config(ARCH)
    prompts = shared_prefix_prompts(4, ENGINE_REQUESTS, SHARED_PREFIX,
                                    PROMPT_LEN - SHARED_PREFIX, cfg.vocab_size)
    with torch.inference_mode():
        eng, st, launches, _ = run_engine(torch, dev, cfg, params, prompts, "a",
                                          prefix_cache=True)
        if st["prefix_hit_pages"] <= 0:
            fail("engine a: the shared prefix never hit the prefix cache")

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
        profile_call(torch, "one engine decode tick (8 slots, paged)", eng.step,
                     statistics.median(walls))
        if eng.decode_ticks != before + 1:
            fail("the profiled engine tick is not a decode tick")
        eng.run_until_drained()
        del eng
        torch.cuda.empty_cache()

        _, st_b, _, _ = run_engine(torch, dev, cfg, params, prompts, "b",
                                   num_pages=TIGHT_PAGES)
        if st_b["preemptions"] < 1:
            fail(f"engine b: no preemption on a {TIGHT_PAGES}-page pool")
    return launches


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
    reports = build.build_all(["kron_gather", "kron_matmul", "paged_attention"])
    log(f"[env] kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for name, out in reports.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    kernels = check_kernels(torch, dev) + check_paged_kernels(torch, dev)
    params = init_params(torch, dev)
    launches = drive_main_path(torch, dev, params)  # slice 1's path
    engine_launches = drive_engine(torch, dev, params)  # slice 2's path, run (a)
    check_paged_step_fp32(torch, dev, params)
    for e in kernels:
        path = engine_launches if e["name"].startswith("paged") else launches
        e["launches"] = path[e["name"]]
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
