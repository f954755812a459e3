"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and nvcc; without a card they skip. They
import nothing of JAX, so they also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Tolerances (fp32): kron_gather atol 1e-4 — outputs are sums of up to 32
unit-variance LN rows and the kernel takes the order-2 LN moments by the
separable formula; kron_matmul atol 1e-4 + rtol 1e-5 — the kernel sums a
depth-(r·q2) contraction in another order than the plain chain. The paged
split and combine: atol 1e-5 + rtol 1e-5 in fp32 (the same page-by-page
online softmax in another summation order); with bf16/fp16 pools atol 1e-2
+ rtol 1e-3, because a probability rounded to 16 bits before the PV product
can land one unit (2^-9 at 0.5 in bf16) apart when its fp32 score differs
in the last bit, times |v| up to about 5.

The training legs: the kron_gather stats leg atol 1e-5 + rtol 1e-4 on the
moments (the kernel takes them by the separable formula); its backward
atol 1e-5·max|dF| + rtol 1e-4 (a token-order sum over up to N rows per
factor column, against the plain version's index_add_), and two runs
equal bit for bit on repeated ids. The kron_matmul backward (ket linears):
dx and dF within atol 1e-5·max + rtol 1e-4 of the plain version (sums of
r·t1 terms for dx, of up to B·t1 for dF, in another order: per-chunk
partials added in chunk order), within four times the plain version's
own distance (or 1e-6 of the largest entry) of a float64 backward, and two
runs equal bit for bit. The fused CE forward: atol 1e-4 + rtol 1e-5
on the losses (exponential sums over up to 152,100 columns in another
order), atol 1e-5 + rtol 1e-5 on m, rtol 2e-4 on l, which carries the
logits' absolute rounding (about 1e-4 at |logit| ~ 100 with these
factors). Its backward: atol 1e-4·max + rtol 1e-4 on dh and dF, whose
entries are sums over every vocabulary column (and token) of softmax −
onehot terms that cancel; against a float64 backward, within four times
the fp32 plain version's own distance or 1e-5 of the largest entry (the
kernel sums over its 195 columns and 64 token blocks in another order);
the kernel's two runs are equal bit for bit (no atomics). The smoke
training steps: per-step losses within atol 1e-5 + rtol 1e-4 of the plain
route; parameters after three AdamW steps all
within 2·lr per step (AdamW normalizes each update, so a near-zero gradient
that differs in its last bits can move a parameter by up to lr either way)
and 99.9% of them within 1e-5.

The flash-attention forward (``csrc/flash_attn.cu``: the tensor-core
kernel for bf16 and fp16, the CUDA-core kernel for fp32, by the wrapper's
static route table, each counted on its own) against ``attention_ref``:
rtol 2e-4 + atol 2e-5 in fp32 (the same online softmax as the Pallas
kernel, scores and sums in another order), 3e-2 in bf16 and fp16 (outputs
rounded to 16 bits; the kernel also rounds each probability to 16 bits
before the PV product, the oracle does not); in bf16 and fp16 also each
output row (one query and head) within 1e-2 of its norm of
``attention_ref`` on the same values in fp32 (two roundings of 2^-9
relative each, where a dropped or misplaced key tile moves a row by
several per cent). The tensor-core kernel against ``flash_tiles_ref``,
its own algorithm tile by tile, on the same bf16 values: atol 1e-2 +
rtol 1e-2, since the two differ only in the order of the fp32 dot's sums,
which can move a rounded probability or an output one bf16 unit (2^-7
relative at most); and two calls give the same bits. The fp32 prefill
through the kernel against ``use_kernels=False``: atol 1e-4 + rtol 1e-5 on
the last hidden state and the caches.

The quantized serving legs (int8 and fp8 payloads with per-rank scales)
take the tolerances of their fp32 legs: the kernels and the plain versions
dequantize to the same floats (``float(q) * scale``) and then differ only
in summation order, as the fp32 legs do.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import ketops
from repro_torch.core import quant as Q
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.kernels.flash_attn import ops as FA
from repro_torch.kernels.flash_attn.ref import flash_tiles_ref
from repro_torch.kernels.kron_gather import ops as G
from repro_torch.kernels.kron_logits import ops as CE
from repro_torch.kernels.kron_matmul import ops as M
from repro_torch.models import model as MD
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.serve.cache import identity_ptab
from repro_torch.train.step import TrainConfig, make_train_step, with_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain chain in full fp32
    return torch.device("cuda")


def _factors(dev, rank, q, t, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((rank, qj, tj), generator=g, device=dev) * 0.3
            for qj, tj in zip(q, t)]


GATHER = [(2, (8, 8), (32, 32), 37, True), (3, (8, 4), (17, 13), 5, False),
          (32, (64, 32), (390, 390), 131, True)]


@pytest.mark.parametrize("rank,q,t,n,ln", GATHER)
def test_kron_gather_kernel_matches_plain(dev, rank, q, t, n, ln):
    f = _factors(dev, rank, q, t)
    total = math.prod(t)
    ids = torch.randint(0, total, (n,), device=dev, dtype=torch.int32)
    ids[0], ids[-1] = 0, total - 1
    dim = math.prod(q) - 1
    before = G.launches["kron_gather_fwd"]
    got = G.kron_gather(f, ids, dim, ln)
    torch.cuda.synchronize()
    assert G.launches["kron_gather_fwd"] == before + 1
    want = G.kron_gather(f, ids, dim, ln, use_kernel=False)
    assert got.shape == (n, dim) and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def test_kron_gather_out_of_range_ids_give_nan_rows(dev):
    f = _factors(dev, 2, (8, 8), (32, 32))
    got = G.kron_gather(f, torch.tensor([-1, 5, 1024], device=dev, dtype=torch.int32), 64)
    assert torch.isnan(got[0]).all() and torch.isnan(got[2]).all()
    assert torch.isfinite(got[1]).all()


MATMUL = [(2, (8, 8), (32, 32), 3, 64, 1024), (4, (8, 4), (17, 13), 5, 29, 200),
          (32, (64, 32), (390, 390), 8, 2048, 151936),
          (32, (64, 32), (390, 390), 1, 2048, 151936)]


@pytest.mark.parametrize("rank,q,t,b,d_in,out_dim", MATMUL)
def test_kron_matmul_kernel_matches_plain(dev, rank, q, t, b, d_in, out_dim):
    f = _factors(dev, rank, q, t)
    x = torch.randn((b, d_in), device=dev)
    before = M.launches["kron_matmul_fwd"]
    got = M.kron_matmul(f, x, out_dim)
    torch.cuda.synchronize()
    assert M.launches["kron_matmul_fwd"] == before + 1
    want = M.kron_matmul(f, x, out_dim, use_kernel=False)
    assert got.shape == (b, out_dim) and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def test_order_3_is_refused_on_the_card(dev):
    f = _factors(dev, 2, (2, 2, 2), (3, 3, 3))
    with pytest.raises(NotImplementedError):
        G.kron_gather(f, torch.zeros(2, device=dev, dtype=torch.int32), 8)
    with pytest.raises(NotImplementedError):
        M.kron_matmul(f, torch.zeros(2, 8, device=dev), 27)


def test_smoke_serving_kernel_route_matches_plain(dev):
    cfg = get_smoke("qwen3-1.7b", dtype=torch.float32)
    params = MD.init_params(cfg, seed=0, device=dev)
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32)
    lens = torch.tensor([8, 5], device=dev, dtype=torch.int32)
    outs = []
    for c in (cfg, plain_cfg):
        cache = MD.init_cache(c, 2, 16, device=dev)
        logits, cache = MD.prefill_chunk_fn(params, c, cache, toks, lens)
        step_logits, cache = MD.serve_step_fn(params, c, cache, logits.argmax(-1).int())
        outs.append((logits, step_logits))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def _paged_inputs(dev, dtype, B, H, KVH, Dh, ps, NP, lens, seed=0):
    """Random pools with a NaN trash page (row 0), a permuted table whose
    entries past each slot's valid pages are trash, unless the slot runs
    past the table."""
    g = torch.Generator(device=dev).manual_seed(seed)
    P = 1 + B * NP
    q = torch.randn((B, H, Dh), generator=g, device=dev).to(dtype)
    kp = torch.randn((P, ps, KVH, Dh), generator=g, device=dev).to(dtype)
    vp = torch.randn((P, ps, KVH, Dh), generator=g, device=dev).to(dtype)
    kp[0] = float("nan")
    vp[0] = float("nan")
    ptab = (torch.randperm(P - 1, generator=g, device=dev)[:B * NP] + 1).reshape(B, NP)
    for b, n in enumerate(lens):
        ptab[b, -(-n // ps):] = 0  # past the table: fully mapped
    return q, kp, vp, ptab.to(torch.int32), torch.tensor(lens, dtype=torch.int32,
                                                          device=dev)


PAGED = [  # dtype, B, H, KVH, Dh, ps, NP, lens
    (torch.float32, 3, 4, 2, 16, 4, 5, (0, 13, 23)),
    (torch.float32, 8, 16, 8, 128, 16, 32, (0, 1, 17, 100, 512, 600, 333, 16)),
    (torch.bfloat16, 8, 16, 8, 128, 16, 32, (0, 1, 17, 100, 512, 600, 333, 16)),
    (torch.float16, 2, 8, 1, 64, 8, 6, (47, 5)),
]
PAGED_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=1e-2, rtol=1e-3),
             torch.float16: dict(atol=1e-2, rtol=1e-3)}


@pytest.mark.parametrize("kv_splits", [1, 3, 8, 64])
@pytest.mark.parametrize("dtype,B,H,KVH,Dh,ps,NP,lens", PAGED)
def test_paged_split_and_combine_kernels_match_plain(dev, kv_splits, dtype, B, H, KVH,
                                                     Dh, ps, NP, lens):
    args = _paged_inputs(dev, dtype, B, H, KVH, Dh, ps, NP, lens)
    before = dict(FA.launches)
    got = FA.paged_attention_split(*args, kv_splits=kv_splits)
    out = FA.combine_splits(*got)
    torch.cuda.synchronize()
    assert FA.launches == {**before, "paged_split": before["paged_split"] + 1,
                           "paged_combine": before["paged_combine"] + 1}
    want = FA.paged_attention_split(*args, kv_splits=kv_splits, use_kernel=False)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **PAGED_TOL[dtype])
    torch.testing.assert_close(out, FA.combine_splits(*got, use_kernel=False),
                               atol=1e-5, rtol=1e-5)
    assert (out[0] == 0).all() == (lens[0] == 0)


def test_paged_kernels_refuse_unsupported_shapes(dev):
    q, kp, vp, ptab, lens = _paged_inputs(dev, torch.bfloat16, 2, 6, 2, 128, 16, 4,
                                          (5, 9))
    with pytest.raises(ValueError):  # group 3
        FA.paged_attention_split(q, kp, vp, ptab, lens, kv_splits=2)
    with pytest.raises(ValueError):  # int64 table
        FA.paged_attention_split(q[:, :4].contiguous(), kp, vp, ptab.long(), lens,
                                 kv_splits=2)


def test_smoke_paged_serving_kernel_route_matches_plain(dev):
    cfg = get_smoke("qwen3-1.7b", dtype=torch.float32)
    params = MD.init_params(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32)
    lens = torch.tensor([8, 5], device=dev, dtype=torch.int32)
    outs = []
    for c in (cfg, dataclasses.replace(cfg, use_kernels=False)):
        cache = identity_ptab(MD.init_cache(c, 2, 64, paged=True, device=dev), 2)
        logits, cache = MD.prefill_chunk_fn(params, c, cache, toks, lens)
        before = dict(FA.launches)
        step_logits, cache = MD.serve_step_fn(params, c, cache, logits.argmax(-1).int())
        launched = FA.launches["paged_split"] - before["paged_split"]
        assert launched == (cfg.num_layers if c.use_kernels is None else 0)
        outs.append(step_logits)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=1e-5)


def _close_scaled(got, want, rtol=1e-4, scale=1e-5):
    """atol scale·max|want| + rtol (sums in another order, some by atomics)."""
    torch.testing.assert_close(got, want, atol=scale * want.abs().max().item(), rtol=rtol)


@pytest.mark.parametrize("rank,q,t,n,ln", GATHER + [(32, (64, 32), (390, 390), 2048, True)])
def test_kron_gather_training_legs_match_plain(dev, rank, q, t, n, ln):
    f = _factors(dev, rank, q, t)
    total = math.prod(t)
    ids = torch.randint(0, total, (n,), device=dev, dtype=torch.int32)
    ids[0], ids[-1], ids[2] = 0, total - 1, ids[1]  # a repeated id
    dim = math.prod(q) - (0 if n == 2048 else 1)
    before = dict(G.launches)
    res = G.kron_gather_cuda(f, ids, dim, ln, with_stats=ln)
    out, stats = res if ln else (res, None)
    want_out, want_stats = G.kron_gather_fwd_ref(f, ids, embed_dim=dim, use_layernorm=ln)
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=1e-5)
    if ln:
        torch.testing.assert_close(stats, want_stats, atol=1e-5, rtol=1e-4)
    g = torch.randn((n, dim), device=dev)
    got = G.kron_gather_bwd_cuda(f, ids, g, stats, ln)
    torch.cuda.synchronize()
    want = G.kron_gather_bwd_ref(f, ids, g, want_stats, use_layernorm=ln)
    for a, b in zip(got, want):
        _close_scaled(a, b)
    assert G.launches["kron_gather_bwd"] == before["kron_gather_bwd"] + 1
    key = "kron_gather_fwd_stats" if ln else "kron_gather_fwd"
    assert G.launches[key] == before[key] + 1


# (rank, q, t, vocab, N, h width)
CE_CASES = [(2, (8, 8), (32, 32), 1000, 37, 64), (3, (8, 4), (17, 13), 200, 70, 30),
            (32, (64, 32), (390, 390), 151936, 2048, 2048)]


@pytest.mark.parametrize("rank,q,t,vocab,n,width", CE_CASES)
def test_kron_ce_kernels_match_plain(dev, rank, q, t, vocab, n, width):
    f = _factors(dev, rank, q, t, seed=1)
    h = torch.randn((n, width), device=dev)
    y = torch.randint(0, vocab, (n,), device=dev, dtype=torch.int32)
    y[0], y[-1] = 0, vocab - 1
    before = dict(CE.launches)
    loss, m, l = CE.kron_ce_fwd_cuda(f, h, y, vocab)
    want_loss, want_m, want_l = CE.kron_ce_fwd_ref(f, h, y, vocab, 4)
    torch.testing.assert_close(loss, want_loss, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(m, want_m, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, want_l, atol=0.0, rtol=2e-4)
    g = (torch.rand(n, device=dev) + 0.5) / n
    dfs, dh = CE.kron_ce_bwd_cuda(f, h, y, m, l, g, vocab)
    torch.cuda.synchronize()
    want_dfs, want_dh = CE.kron_ce_bwd_ref(f, h, y, m, l, g, vocab, 4)
    assert dh.shape == h.shape
    for a, b in zip([dh, *dfs], [want_dh, *want_dfs]):
        _close_scaled(a, b, scale=1e-4)
    # the kernel is about as close to a float64 backward as the fp32 plain one
    exact_dfs, exact_dh = CE.kron_ce_bwd_ref([x.double() for x in f], h.double(), y,
                                             m.double(), l.double(), g.double(), vocab, 4)
    for a, b, e in zip([dh, *dfs], [want_dh, *want_dfs], [exact_dh, *exact_dfs]):
        err_kernel = (a.double() - e).abs().max().item()
        err_plain = (b.double() - e).abs().max().item()
        assert err_kernel <= max(4 * err_plain, 1e-5 * e.abs().max().item())
    again = CE.kron_ce_bwd_cuda(f, h, y, m, l, g, vocab)
    assert torch.equal(again[1], dh) and all(torch.equal(a, b) for a, b in zip(again[0], dfs))
    assert CE.launches == {"kron_ce_fwd": before["kron_ce_fwd"] + 1,
                           "kron_ce_bwd": before["kron_ce_bwd"] + 2}


def test_kron_ce_refuses_unsupported_heads(dev):
    x, y = torch.zeros(3, 48, device=dev), torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):
        CE.kron_ce_fwd_cuda(_factors(dev, 2, (8, 6), (5, 5)), x, y, 25)


def test_smoke_training_kernel_route_matches_plain(dev):
    cfg = get_smoke("qwen3-1.7b", dtype=torch.float32)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    runs = []
    for c in (cfg, dataclasses.replace(cfg, use_kernels=False)):
        state = with_params(MD.init_params(c, seed=0, device=dev))
        step = make_train_step(c, tcfg)
        before = {**G.launches, **CE.launches, "flash_fwd": FA.launches["flash_fwd"],
                  "flash_fwd_tc": FA.launches["flash_fwd_tc"]}
        losses = []
        for i in range(3):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dcfg, i).items()}
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
        after = {**G.launches, **CE.launches, "flash_fwd": FA.launches["flash_fwd"],
                 "flash_fwd_tc": FA.launches["flash_fwd_tc"]}
        runs.append((torch.stack(losses), list(tree_leaves(state["params"])),
                     {k: after[k] - before[k] for k in after}))
    (l_k, p_k, n_k), (l_p, p_p, n_p) = runs
    # flash (fp32: the CUDA-core kernel): each layer's forward and its
    # recompute in the backward
    assert n_k == {"kron_gather_fwd": 0, "kron_gather_fwd_stats": 3, "kron_gather_bwd": 3,
                   "kron_gather_fwd_quant": 0, "kron_ce_fwd": 3, "kron_ce_bwd": 3,
                   "flash_fwd": 3 * 2 * cfg.num_layers, "flash_fwd_tc": 0}
    assert not any(n_p.values())
    torch.testing.assert_close(l_k, l_p, atol=1e-5, rtol=1e-4)
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(p_k, p_p)])
    assert diff.max().item() <= 2 * 3 * tcfg.optimizer.lr
    assert (diff > 1e-5).float().mean().item() < 1e-3


# (rank, q, t, B, d_in, out_dim): the smoke config's ket linears, a padded
# case (d_in < prod q, out_dim < prod t), and the four qwen3-1.7b ket-linear
# shapes at rank 8 (q/o, k/v, wi/wg, FFN wo) at 2,048 tokens
KET = [(8, (8, 8), (8, 4), 37, 64, 32), (8, (8, 8), (16, 12), 37, 64, 192),
       (8, (16, 12), (8, 8), 37, 192, 64), (4, (8, 4), (17, 13), 5, 29, 200),
       (8, (64, 32), (64, 32), 2048, 2048, 2048), (8, (64, 32), (32, 32), 2048, 2048, 1024),
       (8, (64, 32), (96, 64), 2048, 2048, 6144), (8, (96, 64), (64, 32), 2048, 6144, 2048)]


@pytest.mark.parametrize("rank,q,t,b,d_in,out_dim", KET)
def test_kron_matmul_backward_kernel_matches_plain(dev, rank, q, t, b, d_in, out_dim):
    f = _factors(dev, rank, q, t, seed=2)
    x = torch.randn((b, d_in), device=dev)
    g = torch.randn((b, out_dim), device=dev)
    before = dict(M.launches)
    dx, dfs = M.kron_matmul_bwd_cuda(f, x, g)
    torch.cuda.synchronize()
    assert M.launches == {**before, "kron_matmul_bwd": before["kron_matmul_bwd"] + 1}
    want_dx, want_dfs = M.kron_matmul_bwd_ref(f, x, g)
    assert dx.shape == (b, math.prod(q)) and [d.shape for d in dfs] == [a.shape for a in f]
    exact_dx, exact_dfs = M.kron_matmul_bwd_ref([a.double() for a in f], x.double(),
                                                g.double())
    for got, want, exact in zip([dx, *dfs], [want_dx, *want_dfs], [exact_dx, *exact_dfs]):
        _close_scaled(got, want)
        err_kernel = (got.double() - exact).abs().max().item()
        err_plain = (want.double() - exact).abs().max().item()
        assert err_kernel <= max(4 * err_plain, 1e-6 * exact.abs().max().item())
    again = M.kron_matmul_bwd_cuda(f, x, g)
    assert torch.equal(again[0], dx) and all(torch.equal(a, b) for a, b in zip(again[1], dfs))


def test_kron_matmul_autograd_routes_agree(dev):
    f = [a.requires_grad_(True) for a in _factors(dev, 8, (16, 12), (8, 8), seed=3)]
    x = torch.randn((33, 192), device=dev, dtype=torch.bfloat16, requires_grad=True)
    grads = []
    for use_kernel in (None, False):
        before = dict(M.launches)
        y = M.kron_matmul(f, x, 64, use_kernel=use_kernel)
        assert y.dtype == torch.bfloat16
        grads.append(torch.autograd.grad(y.float().square().sum(), [x, *f]))
        launched = {k: M.launches[k] - before[k] for k in before}
        assert launched == ({"kron_matmul_fwd": 1, "kron_matmul_bwd": 1,
                             "kron_matmul_fwd_quant": 0}
                            if use_kernel is None else {"kron_matmul_fwd": 0,
                                                        "kron_matmul_bwd": 0,
                                                        "kron_matmul_fwd_quant": 0})
    assert grads[0][0].dtype == torch.bfloat16
    for a, b in zip(*grads):
        _close_scaled(a.float(), b.float(), rtol=1e-2, scale=1e-2)


def test_kron_gather_backward_gives_the_same_bits(dev):
    f = _factors(dev, 32, (64, 32), (390, 390))
    ids = torch.randint(0, 390 * 390, (2048,), device=dev, dtype=torch.int32)
    ids[1:300] = ids[300:599]  # ids that repeat, so columns sum several rows
    out, stats = G.kron_gather_cuda(f, ids, 2048, True, with_stats=True)
    g = torch.randn((2048, 2048), device=dev)
    first = G.kron_gather_bwd_cuda(f, ids, g, stats)
    second = G.kron_gather_bwd_cuda(f, ids, g, stats)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    untouched = torch.ones(390, dtype=torch.bool, device=dev)
    untouched[(ids.long() // 390)] = False
    assert (first[0][:, :, untouched] == 0).all()


def test_smoke_ket_training_kernel_route_matches_plain(dev):
    cfg = get_smoke("qwen3-1.7b", dtype=torch.float32, linear_kind="ket")
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    runs = []
    for c in (cfg, dataclasses.replace(cfg, use_kernels=False, linear_use_kernel=False)):
        state = with_params(MD.init_params(c, seed=0, device=dev))
        step = make_train_step(c, tcfg)
        before = dict(M.launches)
        losses = []
        for i in range(3):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dcfg, i).items()}
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
        runs.append((torch.stack(losses), list(tree_leaves(state["params"])),
                     {k: M.launches[k] - before[k] for k in before}))
    (l_k, p_k, n_k), (l_p, p_p, n_p) = runs
    per_pass = 7 * cfg.num_layers  # seven ket projections per layer
    # the forward, its per-layer recompute in the backward, one backward each
    assert n_k == {"kron_matmul_fwd": 3 * 2 * per_pass, "kron_matmul_bwd": 3 * per_pass,
                   "kron_matmul_fwd_quant": 0}
    assert not any(n_p.values())
    torch.testing.assert_close(l_k, l_p, atol=1e-5, rtol=1e-4)
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(p_k, p_p)])
    assert diff.max().item() <= 2 * 3 * tcfg.optimizer.lr
    assert (diff > 1e-5).float().mean().item() < 1e-3


def _quantized(dev, mode, rank, q, t, seed=0):
    fq = [Q.quantize(f, mode) for f in _factors(dev, rank, q, t, seed=seed)]
    return [f["q"] for f in fq], [f["scale"] for f in fq]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("rank,q,t,n,ln", GATHER + [(32, (64, 32), (390, 390), 8, False)])
def test_kron_gather_quant_kernel_matches_plain(dev, mode, rank, q, t, n, ln):
    payloads, scales = _quantized(dev, mode, rank, q, t)
    total = math.prod(t)
    ids = torch.randint(0, total, (n,), device=dev, dtype=torch.int32)
    ids[0], ids[-1] = 0, total - 1
    dim = math.prod(q) - 1
    before = dict(G.launches)
    got = G.kron_gather_quant(payloads, scales, ids, dim, ln)
    torch.cuda.synchronize()
    assert G.launches == {**before,
                          "kron_gather_fwd_quant": before["kron_gather_fwd_quant"] + 1}
    want = G.kron_gather_quant(payloads, scales, ids, dim, ln, use_kernel=False)
    assert got.shape == (n, dim) and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    bad = G.kron_gather_quant(payloads, scales,
                              torch.tensor([-1, 3, total], device=dev, dtype=torch.int32), dim)
    assert torch.isnan(bad[0]).all() and torch.isnan(bad[2]).all()
    assert torch.isfinite(bad[1]).all()


# (rank, q, t, B, d_in, out_dim): a padded case, the head at B = 8 and 1, and
# the four rank-8 ket projections at B = 8 (decode) and 128 (prefill chunks)
QUANT_MATMUL = [(4, (8, 4), (17, 13), 5, 29, 200),
                (32, (64, 32), (390, 390), 8, 2048, 151936),
                (32, (64, 32), (390, 390), 1, 2048, 151936)] + [
    (8, q, t, b, d_in, d_out) for b in (8, 128)
    for q, t, d_in, d_out in (((64, 32), (64, 32), 2048, 2048),
                              ((64, 32), (32, 32), 2048, 1024),
                              ((64, 32), (96, 64), 2048, 6144),
                              ((96, 64), (64, 32), 6144, 2048))]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("rank,q,t,b,d_in,out_dim", QUANT_MATMUL)
def test_kron_matmul_quant_kernel_matches_plain(dev, mode, rank, q, t, b, d_in, out_dim):
    payloads, scales = _quantized(dev, mode, rank, q, t, seed=4)
    x = torch.randn((b, d_in), device=dev)
    before = dict(M.launches)
    got = M.kron_matmul_quant(payloads, scales, x, out_dim)
    torch.cuda.synchronize()
    assert M.launches == {**before,
                          "kron_matmul_fwd_quant": before["kron_matmul_fwd_quant"] + 1}
    want = M.kron_matmul_quant(payloads, scales, x, out_dim, use_kernel=False)
    assert got.shape == (b, out_dim) and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def test_mixed_quantized_stacks_are_refused_on_the_card(dev):
    f = _factors(dev, 2, (8, 8), (32, 32))
    mixed = [Q.quantize(f[0], "int8"), f[1]]
    spec = ketops.KronSpec(in_dim=64, out_dim=1024, rank=2, q_dims=(8, 8), t_dims=(32, 32))
    with pytest.raises(NotImplementedError):
        ketops.apply_vector(spec, {"factors": mixed},
                            torch.zeros(2, device=dev, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        ketops.apply_matrix_factors(mixed, torch.zeros(2, 64, device=dev), 1024)
    plain = ketops.apply_matrix_factors(mixed, torch.ones(2, 64, device=dev), 1024,
                                        use_kernel=False)
    assert torch.isfinite(plain).all()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("linear", ["dense", "ket"])
def test_smoke_quant_serving_kernel_route_matches_plain(dev, linear, mode):
    kw = dict(linear_kind="ket", linear_rank=4) if linear == "ket" else {}
    cfg = get_smoke("qwen3-1.7b", dtype=torch.float32, quant=mode, **kw)
    params = MD.init_params(cfg, seed=0, device=dev)
    assert Q.is_quantized(params["head"]["factors"][0])
    plain_cfg = dataclasses.replace(cfg, use_kernels=False, linear_use_kernel=False)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=dev, dtype=torch.int32)
    lens = torch.tensor([8, 5], device=dev, dtype=torch.int32)
    outs = []
    for c in (cfg, plain_cfg):
        before = (dict(G.launches), dict(M.launches))
        cache = MD.init_cache(c, 2, 16, device=dev)
        logits, cache = MD.prefill_chunk_fn(params, c, cache, toks, lens)
        step_logits, cache = MD.serve_step_fn(params, c, cache, logits.argmax(-1).int())
        outs.append((logits, step_logits))
        if c is cfg:  # two calls: one quantized lookup, 1 + 21 ket chains each
            n_mm = 2 * (1 + (7 * cfg.num_layers if linear == "ket" else 0))
            assert G.launches["kron_gather_fwd_quant"] == before[0]["kron_gather_fwd_quant"] + 2
            assert M.launches["kron_matmul_fwd_quant"] == \
                before[1]["kron_matmul_fwd_quant"] + n_mm
            assert G.launches["kron_gather_fwd"] == before[0]["kron_gather_fwd"]
            assert M.launches["kron_matmul_fwd"] == before[1]["kron_matmul_fwd"]
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4),
             torch.bfloat16: dict(atol=3e-2, rtol=3e-2),
             torch.float16: dict(atol=3e-2, rtol=3e-2)}
FLASH_ROW_RTOL = 1e-2  # 16-bit rows against the fp32 oracle, relative to the row's norm
# (Sq, Skv): equal and ragged, queries before and past the keys, lengths
# that straddle the 64- and 128-row tiles; the window of 40 leaves the last
# rows of (150, 77) and of (257, 130) with no key (the mean of v), so their
# last query blocks walk every key tile
FLASH_LENGTHS = ((129, 129), (77, 150), (150, 77), (257, 257), (128, 300), (257, 130))
FLASH_MASKS = {"causal": (True, 0), "window": (True, 40), "bidirectional": (False, 0)}


def _qkv(dev, dtype, B, Sq, Skv, H, KVH, Dh, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((B, Sq, H, Dh), (B, Skv, KVH, Dh), (B, Skv, KVH, Dh))]


def _assert_flash_close(got, q, k, v, causal=True, window=0):
    want = FA.attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[q.dtype])
    if q.dtype != torch.float32:
        want = FA.attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
        row_err = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
        assert row_err.max().item() <= FLASH_ROW_RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mask", list(FLASH_MASKS))
@pytest.mark.parametrize("Dh", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_flash_kernel_matches_attention_ref(dev, G, Dh, mask, dtype):
    causal, window = FLASH_MASKS[mask]
    route = "flash_fwd" if dtype == torch.float32 else "flash_fwd_tc"
    assert FA.flash_route(dtype, Dh) == route
    for Sq, Skv in FLASH_LENGTHS:
        q, k, v = _qkv(dev, dtype, 2, Sq, Skv, 2 * G, 2, Dh)
        before = dict(FA.launches)
        got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert FA.launches == {**before, route: before[route] + 1}
        _assert_flash_close(got, q, k, v, causal, window)


def test_flash_kernel_takes_fp16(dev):
    q, k, v = _qkv(dev, torch.float16, 1, 100, 100, 16, 8, 128)
    before = FA.launches["flash_fwd_tc"]
    _assert_flash_close(FA.flash_attention_cuda(q, k, v), q, k, v)
    assert FA.launches["flash_fwd_tc"] == before + 1


@pytest.mark.parametrize("mask", list(FLASH_MASKS))
@pytest.mark.parametrize("Dh", [16, 64, 128])
def test_flash_tc_kernel_matches_its_tile_walk(dev, Dh, mask):
    causal, window = FLASH_MASKS[mask]
    for Sq, Skv in FLASH_LENGTHS:
        q, k, v = _qkv(dev, torch.bfloat16, 2, Sq, Skv, 8, 2, Dh, seed=1)
        got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = flash_tiles_ref(q, k, v, causal=causal, window=window)
        assert got.dtype == want.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
        assert torch.equal(FA.flash_attention_cuda(q, k, v, causal=causal, window=window),
                           got)


def test_flash_kernel_refuses_unsupported_shapes(dev):
    q, k, v = _qkv(dev, torch.bfloat16, 1, 16, 16, 4, 2, 64)
    for bad in (
        _qkv(dev, torch.bfloat16, 1, 16, 16, 4, 2, 80),  # head_dim 80
        _qkv(dev, torch.bfloat16, 1, 16, 16, 4, 2, 48),  # head_dim 48
        _qkv(dev, torch.bfloat16, 1, 16, 16, 6, 4, 64),  # 6 heads over 4 kv heads
        (q, k, v[..., :32].contiguous()),  # Dv != Dh
        (q, k.float(), v),  # mixed dtypes
        (q.transpose(1, 2), k, v),  # not contiguous
        (q, k[:, :0], v[:, :0]),  # no key
    ):
        with pytest.raises(ValueError):
            FA.flash_attention_cuda(*bad)
    with pytest.raises(ValueError):
        FA.flash_attention_cuda(q, k, v, window=-1)


@pytest.mark.parametrize("mask", list(FLASH_MASKS))
def test_flash_autograd_routes_agree(dev, mask):
    causal, window = FLASH_MASKS[mask]
    g = torch.Generator(device=dev).manual_seed(3)
    ct = torch.randn((2, 150, 8, 128), generator=g, device=dev)
    runs = []
    for use_kernel in (None, False):
        qkv = [t.requires_grad_(True) for t in _qkv(dev, torch.float32, 2, 150, 150, 8, 4, 128)]
        before = dict(FA.launches)
        out = FA.flash_attention(*qkv, causal=causal, window=window, use_kernel=use_kernel)
        grads = torch.autograd.grad(out, qkv, ct)
        assert FA.launches == {**before, "flash_fwd": before["flash_fwd"] + (use_kernel is None)}
        runs.append((out.detach(), grads))
    (o_k, g_k), (o_p, g_p) = runs
    torch.testing.assert_close(o_k, o_p, **FLASH_TOL[torch.float32])
    for a, b in zip(g_k, g_p):  # both the oracle's VJP on the same saved inputs
        assert torch.equal(a, b)


def test_smoke_prefill_fn_kernel_route_matches_plain(dev):
    cfg = get_smoke("qwen3-1.7b", dtype=torch.float32)
    params = MD.init_params(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), device=dev, dtype=torch.int32)
    outs = []
    for c in (cfg, dataclasses.replace(cfg, use_kernels=False)):
        before = dict(FA.launches)
        outs.append(MD.prefill_fn(params, c, {"tokens": toks}))
        ran = cfg.num_layers if c.use_kernels is None else 0  # fp32: the CUDA-core kernel
        assert FA.launches == {**before, "flash_fwd": before["flash_fwd"] + ran}
    (x_k, c_k), (x_p, c_p) = outs
    torch.testing.assert_close(x_k, x_p, atol=1e-4, rtol=1e-5)
    assert len(c_k) == len(c_p) == cfg.num_layers
    for a, b in zip(c_k, c_p):
        for name in ("k", "v"):
            assert a[name].shape == (2, 100, cfg.num_kv_heads, cfg.head_dim)
            torch.testing.assert_close(a[name], b[name], atol=1e-4, rtol=1e-5)


# The stats leg reads its columns from a column-contiguous copy of the
# factor stacks that each call makes first: every id count from one to
# several blocks' worth, repeated ids, the first and last valid ids, ids
# outside [0, t1 t2) (a NaN row and NaN stats), and a stack whose columns
# are not a multiple of 4 floats (scalar loads); the tolerances of the leg
# above, the same bits on a second call, and the same bits as the serving
# leg on the same ids.
@pytest.mark.parametrize("rank,q,t,n", [(32, (64, 32), (390, 390), 1),
                                        (32, (64, 32), (390, 390), 63),
                                        (32, (64, 32), (390, 390), 2047),
                                        (32, (64, 32), (390, 390), 2049),
                                        (32, (64, 32), (390, 390), 8192),
                                        (3, (5, 3), (7, 11), 40)])
def test_kron_gather_stats_leg_edges(dev, rank, q, t, n):
    f = _factors(dev, rank, q, t)
    total = math.prod(t)
    dim = math.prod(q)
    ids = torch.randint(0, total, (n,), device=dev, dtype=torch.int32)
    ids[0] = 0
    if n > 1:
        ids[-1] = total - 1
    if n > 4:
        ids[2], ids[3], ids[4] = ids[1], -1, total  # a repeat, two ids out of range
    before = dict(G.launches)
    out, stats = G.kron_gather_cuda(f, ids, dim, True, with_stats=True)
    torch.cuda.synchronize()
    assert G.launches == {**before,
                          "kron_gather_fwd_stats": before["kron_gather_fwd_stats"] + 1}
    assert out.shape == (n, dim) and stats.shape == (n, 2, rank)
    bad = (ids < 0) | (ids >= total)
    assert torch.isnan(out[bad]).all() and torch.isnan(stats[bad]).all()
    want_out, want_stats = G.kron_gather_fwd_ref(f, ids[~bad], embed_dim=dim)
    torch.testing.assert_close(out[~bad], want_out, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(stats[~bad], want_stats, atol=1e-5, rtol=1e-4)
    again = G.kron_gather_cuda(f, ids, dim, True, with_stats=True)
    assert torch.equal(again[0][~bad], out[~bad]) and torch.equal(again[1][~bad], stats[~bad])
    # the serving leg (strided column loads) sums each output the same way
    assert torch.equal(G.kron_gather_cuda(f, ids, dim, True)[~bad], out[~bad])


def test_kron_gather_stats_leg_refuses_layernorm_off(dev):
    f = _factors(dev, 2, (8, 8), (32, 32))
    with pytest.raises(ValueError):
        G.kron_gather_cuda(f, torch.zeros(3, device=dev, dtype=torch.int32), 64, False,
                           with_stats=True)


# The CE backward beyond CE_CASES: 1, 65 and 2,047 tokens of the qwen3-1.7b
# head (one, two partial and 32 partial 64-token blocks), a vocabulary that
# ends early inside a t1 column (100,000 = 256 x 390 + 160), and a head that
# the static route sends to the CUDA-core kernel (1,024 ranks at q2 = 1:
# its F1 column does not fit the tensor-core kernel). Each: the tolerances
# and the float64 criterion of test_kron_ce_kernels_match_plain, the same
# bits twice, the launch keys unchanged and one call counted on its route.
CE_BWD_EDGES = [(32, (64, 32), (390, 390), 151936, 1, 2048),
                (32, (64, 32), (390, 390), 151936, 65, 2048),
                (32, (64, 32), (390, 390), 151936, 2047, 2000),
                (32, (64, 32), (390, 390), 100000, 300, 2048),
                (1024, (8, 1), (5, 7), 30, 40, 8)]


@pytest.mark.parametrize("rank,q,t,vocab,n,width", CE_BWD_EDGES)
def test_kron_ce_backward_edges(dev, rank, q, t, vocab, n, width):
    f = _factors(dev, rank, q, t, seed=1)
    h = torch.randn((n, width), device=dev)
    y = torch.randint(0, vocab, (n,), device=dev, dtype=torch.int32)
    y[0], y[-1] = vocab - 1, 0
    _, m, l = CE.kron_ce_fwd_cuda(f, h, y, vocab)
    g = (torch.rand(n, device=dev) + 0.5) / n
    route = CE.bwd_route(rank, q[0], q[1], t[1])
    assert route == ("kron_ce_bwd_simt" if rank == 1024 else "kron_ce_bwd_tc")
    before, routes = dict(CE.launches), dict(CE.routes)
    dfs, dh = CE.kron_ce_bwd_cuda(f, h, y, m, l, g, vocab)
    torch.cuda.synchronize()
    assert CE.launches == {**before, "kron_ce_bwd": before["kron_ce_bwd"] + 1}
    assert CE.routes == {**routes, route: routes[route] + 1}
    want_dfs, want_dh = CE.kron_ce_bwd_ref(f, h, y, m, l, g, vocab, 4)
    assert dh.shape == h.shape and [d.shape for d in dfs] == [a.shape for a in f]
    for a, b in zip([dh, *dfs], [want_dh, *want_dfs]):
        _close_scaled(a, b, scale=1e-4)
    exact_dfs, exact_dh = CE.kron_ce_bwd_ref([x.double() for x in f], h.double(), y,
                                             m.double(), l.double(), g.double(), vocab, 4)
    for a, b, e in zip([dh, *dfs], [want_dh, *want_dfs], [exact_dh, *exact_dfs]):
        err_kernel = (a.double() - e).abs().max().item()
        err_plain = (b.double() - e).abs().max().item()
        assert err_kernel <= max(4 * err_plain, 1e-5 * e.abs().max().item())
    again = CE.kron_ce_bwd_cuda(f, h, y, m, l, g, vocab)
    assert torch.equal(again[1], dh) and all(torch.equal(a, b) for a, b in zip(again[0], dfs))
