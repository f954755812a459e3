"""The port's paged serving slice against the JAX package: paged chunked
prefill and decode steps on a permuted page table, the page allocator and
prefix cache on one seeded sequence of operations, and the continuous
batching engine tick by tick on a tight pool with the prefix cache; then
the port's paged, dense and stepwise engines against one another.

Both packages run ``get_smoke("qwen3-1.7b", dtype=float32)`` on the same
parameters (JAX from ``PRNGKey(0)``, converted) and prompts (numpy). The
port runs on ``device="cpu"``, its plain versions. Logits atol 2e-4 in
fp32: 3 layers of fp32 matmuls in another summation order; greedy tokens,
page ids, refcounts, keys and scheduling counters must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import model as JMD
from repro.serve import cache as JSC
from repro.serve import engine as JE
from repro_torch.configs import get_smoke
from repro_torch.convert import jax_params_to_torch
from repro_torch.models import model as MD
from repro_torch.serve import cache as SC
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.faultinject import shared_prefix_prompts

torch.set_num_threads(2)

ATOL = 2e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke("qwen3-1.7b", dtype=jnp.float32)
    tcfg = get_smoke("qwen3-1.7b", dtype=torch.float32)
    jparams = JMD.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = jax_params_to_torch(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                  device="cpu")
    return jcfg, jparams, tcfg, tparams


# ---------------------------------------------------------------------------
# paged prefill + decode steps on a permuted page table
# ---------------------------------------------------------------------------

B, C, MAX_LEN, PS, NUM_PAGES, STEPS = 3, 8, 24, 4, 20, 4
LENS = [(C, C, 0), (C, 3, 0)]  # slot 1 ends mid-chunk, slot 2 idles
# slots 0 and 1 share physical page 5 (their first 4 tokens agree); slot 2
# keeps an all-trash row
PTAB = np.array([[5, 11, 2, 14, 8, 17],
                 [5, 9, 16, 3, 13, 6],
                 [0, 0, 0, 0, 0, 0]], np.int32)


@pytest.fixture(scope="module")
def paged_run(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(0)
    chunks = [rng.integers(0, jcfg.vocab_size, size=(B, C)).astype(np.int32)
              for _ in LENS]
    chunks[0][1, :PS] = chunks[0][0, :PS]
    jprefill = jax.jit(lambda p, c, t, n: JMD.prefill_chunk_fn(p, jcfg, c, t, n))
    jstep = jax.jit(lambda p, c, t: JMD.serve_step_fn(p, jcfg, c, t))
    jcache = JMD.init_cache(jcfg, B, MAX_LEN, paged=True, num_pages=NUM_PAGES,
                            page_size=PS)
    jcache["ptab"] = jnp.asarray(PTAB)
    tcache = MD.init_cache(tcfg, B, MAX_LEN, paged=True, num_pages=NUM_PAGES,
                           page_size=PS, device="cpu")
    tcache["ptab"].copy_(torch.from_numpy(PTAB))
    out = {"jax": [], "torch": [], "tokens": []}
    with torch.inference_mode():
        for toks, lens in zip(chunks, LENS):
            jl, jcache = jprefill(jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray(lens, jnp.int32))
            tl, tcache = MD.prefill_chunk_fn(tparams, tcfg, tcache, torch.from_numpy(toks),
                                             torch.tensor(lens, dtype=torch.int32))
            out["jax"].append(np.asarray(jl))
            out["torch"].append(tl.numpy().copy())
        for _ in range(STEPS):
            tok = np.argmax(out["jax"][-1], axis=-1).astype(np.int32)
            out["tokens"].append((tok, np.argmax(out["torch"][-1], axis=-1)))
            jl, jcache = jstep(jparams, jcache, jnp.asarray(tok))
            tl, tcache = MD.serve_step_fn(tparams, tcfg, tcache, torch.from_numpy(tok))
            out["jax"].append(np.asarray(jl))
            out["torch"].append(tl.numpy().copy())
    out["caches"] = (jcache, tcache)
    return out


@pytest.mark.parametrize("call", range(len(LENS) + STEPS))
def test_paged_logits_match_jax(paged_run, call):
    got, want = paged_run["torch"][call], paged_run["jax"][call]
    assert got.shape == want.shape == (B, 1024)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_paged_greedy_tokens_identical(paged_run):
    for want, got in paged_run["tokens"]:
        np.testing.assert_array_equal(got, want)


def test_paged_live_pool_rows_match_jax(paged_run):
    jcache, tcache = paged_run["caches"]
    rows = sorted(set(PTAB[:2].ravel().tolist()))
    np.testing.assert_array_equal(tcache["step"].numpy(), [16 + STEPS, 11 + STEPS, STEPS])
    np.testing.assert_array_equal(tcache["ptab"].numpy(), np.asarray(jcache["ptab"]))
    for i, layer in enumerate(tcache["layers"]):
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(layer[name][rows].numpy(),
                                       np.asarray(jcache["groups"][0][name][i])[rows],
                                       atol=ATOL, rtol=0)


def test_page_writes_clamp_past_the_table():
    """A position past the table writes into its last page, as the JAX
    gather clamps (the page index never reaches NP)."""
    from repro_torch.serve.decode import _page_write
    pool = torch.zeros(6, 2, 1)
    ptab = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    _page_write(pool, ptab, torch.tensor([1, 7]), torch.tensor([[5.0], [9.0]]))
    assert pool[1, 1, 0] == 5.0 and pool[4, 1, 0] == 9.0
    assert pool.sum() == 14.0


# ---------------------------------------------------------------------------
# allocator + prefix cache on one seeded operation sequence
# ---------------------------------------------------------------------------

def test_allocator_and_prefix_cache_match_jax():
    rng = np.random.default_rng(7)
    ja, ta = JSC.PageAllocator(12), SC.PageAllocator(12)
    jp, tp = JSC.PrefixCache(ja, 4), SC.PrefixCache(ta, 4)
    held: list[int] = []
    keys: list[bytes] = []
    for _ in range(400):
        op = rng.integers(0, 7)
        if op == 0:
            n = int(rng.integers(0, 4))
            got = ta.alloc(n)
            assert got == ja.alloc(n)
            held += got or []
        elif op == 1 and held:
            p = held[int(rng.integers(0, len(held)))]
            ta.acquire(p)
            ja.acquire(p)
            held.append(p)
        elif op == 2 and held:
            p = held.pop(int(rng.integers(0, len(held))))
            ta.release([p])
            ja.release([p])
        elif op == 3:
            toks = rng.integers(0, 50, size=int(rng.integers(0, 14))).tolist()
            toks[:4] = [1, 2, 3, 4][:len(toks)]  # a common first page
            k = tp.page_keys(toks)
            assert k == jp.page_keys(toks)
            keys += k
            got = tp.lookup(k)
            assert got == jp.lookup(k)
            held += got
        elif op == 4 and keys and set(held) - tp.pages:
            # as the engine publishes: a held page not cached under any key
            free_held = sorted(set(held) - tp.pages)
            k = keys[int(rng.integers(0, len(keys)))]
            p = free_held[int(rng.integers(0, len(free_held)))]
            assert tp.insert(k, p) == jp.insert(k, p)
        elif op == 5:
            n = int(rng.integers(0, 3))
            assert tp.evict(n) == jp.evict(n)
        elif op == 6 and keys:
            k = keys[int(rng.integers(0, len(keys)))]
            assert tp.invalidate(k) == jp.invalidate(k)
        ta.check()
        assert ta._free == ja._free
        assert ta.outstanding == ja.outstanding
        assert all(ta.refcount(p) == ja.refcount(p) for p in range(12))
        assert list(tp._map.items()) == list(jp._map.items())
        assert tp.stats() == jp.stats()
    assert tp.stats()["prefix_hits"] > 0 and tp.stats()["prefix_evictions"] > 0


# ---------------------------------------------------------------------------
# the engine, tick by tick, against the JAX engine
# ---------------------------------------------------------------------------

ENGINE = dict(batch_slots=3, max_len=32, page_size=4, prefill_chunk=4,
              num_pages=8, prefix_cache=True)
HOLD_TICKS = (1, 4)  # every free page is held from tick 1 to tick 4: stalls
COUNTERS = ("prefill_ticks", "decode_ticks", "stalled_ticks", "preemptions",
            "cow_copies", "prefix_hit_pages", "completed", "failed",
            "free_pages", "page_capacity", "prefix_hits", "prefix_misses")


def _engine_prompts(vocab: int) -> list[list[int]]:
    prompts = shared_prefix_prompts(1, 5, 8, 5, vocab)
    # an exact repeat of a 2-page prefix: admitted fully covered, it replays
    # its last token into a shared page, which must be copied on write
    return prompts[:2] + [prompts[0][:8]] + prompts[2:] + [prompts[0][:8]]


@pytest.fixture(scope="module")
def engine_traces(models):
    """Both engines on the same requests, one tick at a time: per tick the
    page table and the counters; at the end the outputs."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _engine_prompts(jcfg.vocab_size)
    jeng = JE.ServingEngine(jcfg, jparams, **ENGINE)
    teng = ServingEngine(tcfg, tparams, **ENGINE, device="cpu")
    jreqs = [JE.Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    treqs = [Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    trace = []
    while jeng._has_work() or teng.has_work():
        assert len(trace) < 200
        if len(trace) == HOLD_TICKS[0]:
            assert teng.hold_pages(100) == jeng.hold_pages(100)
        if len(trace) == HOLD_TICKS[1]:
            assert teng.release_held() == jeng.release_held()
        jeng.step()
        teng.step()
        teng.check()
        js, ts = jeng.stats(), teng.stats()
        trace.append((np.asarray(jeng.cache["ptab"]), teng.cache["ptab"].numpy().copy(),
                      {k: js[k] for k in COUNTERS}, {k: ts[k] for k in COUNTERS}))
    return trace, [r.output for r in jreqs], [r.output for r in treqs], teng


def test_engine_outputs_match_jax(engine_traces):
    _, jout, tout, _ = engine_traces
    assert all(len(o) == 4 for o in jout)
    assert tout == jout


def test_engine_schedule_matches_jax_every_tick(engine_traces):
    trace, _, _, _ = engine_traces
    for tick, (jptab, tptab, jc, tc) in enumerate(trace):
        np.testing.assert_array_equal(tptab, jptab, err_msg=f"ptab at tick {tick}")
        assert tc == jc, f"counters at tick {tick}"


def test_engine_exercises_the_paging_paths(engine_traces):
    _, _, _, teng = engine_traces
    st = teng.stats()
    assert st["completed"] == 7 and st["failed"] == 0
    assert st["preemptions"] >= 1 and st["cow_copies"] >= 1 and st["prefix_hit_pages"] >= 1
    assert st["stalled_ticks"] >= 1 and st["decode_ticks"] >= 1
    # at drain only the prefix cache holds pages; evicting it frees them all
    teng.prefix_cache.evict(len(teng.prefix_cache))
    assert teng.stats()["free_pages"] == teng.stats()["page_capacity"]
    assert teng.cfg.decode_kv_splits == 2  # pinned at build: 8 pages, 3 slots, cpu


# ---------------------------------------------------------------------------
# the port's engines against one another
# ---------------------------------------------------------------------------

CONF_PROMPTS = [[5, 17, 33, 2, 9, 40, 11], [7, 3], [1, 2, 3, 4, 5]]


def _run_port_engine(tcfg, tparams, prompts, **kw):
    eng = ServingEngine(tcfg, tparams, batch_slots=kw.pop("batch_slots", 2), max_len=32,
                        prefill_chunk=3, device="cpu", **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    res = eng.run_until_drained()
    assert res.drained
    return [r.output for r in reqs], eng


def test_port_engines_chunked_equals_stepwise_and_direct(models):
    """The chunked paged engine, the stepwise engine and the dense engine
    give the same greedy outputs, each equal to a 1-slot dense stepwise
    engine per prompt (the JAX package's conformance pattern)."""
    _, _, tcfg, tparams = models
    out_chunked, eng_c = _run_port_engine(tcfg, tparams, CONF_PROMPTS)
    out_stepwise, eng_s = _run_port_engine(tcfg, tparams, CONF_PROMPTS,
                                           prefill_mode="stepwise")
    out_dense, _ = _run_port_engine(tcfg, tparams, CONF_PROMPTS, cache_mode="dense")
    assert out_chunked == out_stepwise == out_dense
    for p, o in zip(CONF_PROMPTS, out_chunked):
        ref, _ = _run_port_engine(tcfg, tparams, [p], batch_slots=1, cache_mode="dense",
                                  prefill_mode="stepwise")
        assert ref == [o]
    assert eng_c.stats()["prefill_ticks"] >= 3
    assert eng_s.admission == "reserve" and eng_s.stats()["prefill_ticks"] == 0


def test_engine_streams_cancels_and_expires(models):
    """on_token streams each emitted token once; cancel fails an in-flight
    request; a deadline on an injected clock fails a queued one; drain
    finishes what is in flight and fails what is queued."""
    _, _, tcfg, tparams = models
    now = [0.0]
    eng = ServingEngine(tcfg, tparams, batch_slots=2, max_len=32, page_size=4,
                        prefill_chunk=4, clock=lambda: now[0], device="cpu")
    streamed: list[int] = []
    reqs = [Request(uid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=5,
                    on_token=streamed.append),
            Request(uid=1, prompt=[6, 7, 8], max_new_tokens=5),
            Request(uid=2, prompt=[9, 10], max_new_tokens=5, deadline_s=1.0),
            Request(uid=3, prompt=[11, 12], max_new_tokens=5),
            Request(uid=4, prompt=[13, 14], max_new_tokens=5)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.check()
    assert eng.cancel(1)
    now[0] = 2.0  # uid 2 waited past its deadline in the queue
    eng.step()
    eng.check()
    eng.request_drain()
    res = eng.run_until_drained()
    eng.check()
    assert res.drained
    assert reqs[0].status == "done" and streamed == reqs[0].output and len(streamed) == 5
    assert reqs[3].status == "done"  # admitted into the cancelled request's slot
    assert eng.stats()["fail_reasons"] == {1: "cancelled", 2: "deadline", 4: "drained"}
    assert eng.stats()["free_pages"] == eng.stats()["page_capacity"]


def test_engine_quarantines_nonfinite_logits(models):
    """A slot whose logits go non-finite is requeued once and failed on the
    second strike; the garbage token is never emitted."""
    _, _, tcfg, tparams = models
    eng = ServingEngine(tcfg, tparams, batch_slots=1, max_len=32, device="cpu")
    req = Request(uid=0, prompt=[1, 2, 3], max_new_tokens=3)
    eng.submit(req)
    eng._sample = lambda logits: np.zeros(1, np.int32)
    real = eng._guarded_emit
    eng._guarded_emit = lambda logits, emitting: real(logits * float("nan"), emitting)
    eng.run_until_drained()
    assert req.status == "failed" and req.fail_reason == "nonfinite_logits"
    assert req.output == [] and eng.stats()["quarantines"] == 2


def test_engine_refuses_unported_options(models):
    _, _, tcfg, tparams = models
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ServingEngine(tcfg, tparams)
    with pytest.raises(ValueError, match="prefix_cache"):
        ServingEngine(tcfg, tparams, cache_mode="dense", prefix_cache=True, device="cpu")


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_engine_serves_quantized(models, mode):
    """``quant=`` calibrates the embedding and head stacks at construction;
    the engine then gives the same greedy outputs as an fp32 engine on the
    dequantized parameters (the plain versions dequantize to the same
    floats)."""
    from repro_torch.core import quant as Q
    _, _, tcfg, tparams = models
    out, eng = _run_port_engine(tcfg, tparams, CONF_PROMPTS, quant=mode)
    eng.check()
    assert all(Q.is_quantized(f) for f in eng.params["embed"]["factors"])
    assert eng.stats()["free_pages"] == eng.stats()["page_capacity"]
    want, _ = _run_port_engine(tcfg, Q.dequantize_params(Q.quantize_params(tparams, mode)),
                               CONF_PROMPTS)
    assert out == want and all(len(o) == 4 for o in out)


def test_engine_sampling_is_seeded_and_failures_propagate(models):
    """greedy=False draws from a seeded torch.Generator (the same seed gives
    the same tokens); a failing model call raises EngineStepError with the
    original exception as its cause, and is never retried or degraded."""
    from repro_torch.serve.engine import EngineStepError
    _, _, tcfg, tparams = models

    def sample(seed):
        eng = ServingEngine(tcfg, tparams, batch_slots=2, max_len=32, greedy=False,
                            seed=seed, device="cpu")
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in
                enumerate(CONF_PROMPTS)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.output for r in reqs]

    first = sample(3)
    assert first == sample(3)
    assert all(0 <= t < tcfg.vocab_size for out in first for t in out)
    broken = dict(tparams, final_norm={})
    eng = ServingEngine(tcfg, broken, batch_slots=1, max_len=32, device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
    with pytest.raises(EngineStepError, match="prefill_step failed") as err:
        eng.step()
    assert isinstance(err.value.__cause__, KeyError)
