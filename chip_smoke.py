#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA card and nvcc, builds the
port's CUDA kernels from src/repro_torch/csrc into build/, and exits
non-zero, printing no result, when anything is missing or any phase fails:

1. environment: the card's name and power limit, torch and CUDA versions,
   the kernel build (timed, with nvcc's register / shared-memory report);
2. every kernel of the serving path against its plain PyTorch version at
   the full qwen3-1.7b shapes, with the tolerance stated, and timed with
   CUDA events (device time, L2 flushed before every launch; median of 50)
   beside its bound, the plain version and one PyTorch call as a yardstick;
3. the port's main path at full width: the full qwen3-1.7b config with
   seeded random weights serves 8 prompts of 128 tokens (chunked prefill
   into the dense per-slot cache) and then 32 greedy decode steps, with the
   kernels' launch counts checked; a profile of one more prefill chunk and
   decode step (kernel time against the unprofiled wall time per call, so
   the device's busy and idle share, and the top kernels); then one
   full-width fp32 decode step through the kernels against
   ``use_kernels=False``;
4. a JSON line of the kernels, then ``{"ok": true, "device": ...}`` last.
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


def drive_main_path(torch, dev):
    """Phase 3: the full config serving 8 prompts, launch counts checked."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.kron_gather import ops as G
    from repro_torch.kernels.kron_matmul import ops as M
    from repro_torch.models import model as MD

    cfg = get_config(ARCH)
    C = cfg.prefill_chunk
    t0 = time.perf_counter()
    params = MD.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"[main] {cfg.name}: {MD.param_count(params):,} params (fp32) initialised in "
        f"{time.perf_counter() - t0:.1f} s; activations {cfg.dtype}")
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
    reports = build.build_all(["kron_gather", "kron_matmul"])
    log(f"[env] kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for name, out in reports.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    kernels = check_kernels(torch, dev)
    launches = drive_main_path(torch, dev)
    for e in kernels:
        e["launches"] = launches[e["name"]]
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
