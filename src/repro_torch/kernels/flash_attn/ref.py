"""Plain PyTorch versions of the flash-attention kernels (port of
``repro.kernels.flash_attn.ref``, plus the plain versions of the tensor-core
kernel's tile walk and of the split kernel's function): the full-sequence
oracle :func:`attention_ref`, :func:`flash_tiles_ref` and the split-KV paged
decode read.

The CPU route and the CPU tests run these; on the card ``chip_smoke.py``
holds the CUDA kernels of ``csrc/flash_attn.cu`` and
``csrc/paged_attention.cu`` against them.

Pools are ``(P, page_size, KVH, D)``; ``ptab (B, NP)`` maps slot b's
logical page j to a pool row; ``lens (B,)`` counts each slot's valid
tokens. Scores and sums are fp32.
"""

from __future__ import annotations

import torch

__all__ = ["NEG", "LOG2E", "attention_ref", "flash_tiles_ref", "flash_kv_tiles",
           "combine_splits_ref", "paged_attention_ref", "paged_attention_split_ref",
           "split_layout"]

NEG = -1e30
LOG2E = 1.4426950408889634


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """The full-sequence oracle: q (B, Sq, H, Dh), k (B, Skv, KVH, Dh), v
    (B, Skv, KVH, Dv) -> (B, Sq, H, Dv) in q's dtype. Query head h reads kv
    head ``h // (H / KVH)``; query and key positions both count from 0.
    Builds the full fp32 scores, masks them with NEG (``causal``: keep
    ``kpos <= qpos``; ``window > 0``: keep ``kpos > qpos - window``) and
    takes a softmax, so a row that sees no key averages every value."""
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qf = q.float().reshape(B, Sq, KVH, G, Dh) * (Dh ** -0.5)
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (kpos <= qpos)
    if window > 0:
        valid = valid & (kpos > qpos - window)
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckd->bkgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def flash_kv_tiles(q0: int, Sq: int, Skv: int, causal: bool, window: int, block_q: int = 128,
                   block_k: int = 128) -> tuple[int, int]:
    """The key tiles ``[lo, hi)`` that the block of query rows ``[q0, q0 +
    block_q)`` walks (``kv_tiles`` of ``csrc/flash_attn.cu``): from the
    window's first tile to the causal diagonal, or every tile when the
    block's last row sees no key at all."""
    q_last = min(q0 + block_q, Sq) - 1
    lo, hi = 0, -(-Skv // block_k)
    if not (window > 0 and q_last - window + 1 > Skv - 1):
        if causal:
            hi = min(q_last, Skv - 1) // block_k + 1
        if window > 0:
            lo = max(0, q0 - window + 1) // block_k
    return lo, hi


def flash_tiles_ref(q, k, v, *, causal: bool = True, window: int = 0, block_q: int = 128,
                    block_k: int = 128):
    """The tensor-core flash kernel's algorithm, tile by tile: q (B, Sq, H,
    Dh), k (B, Skv, KVH, Dh), v (B, Skv, KVH, Dv) -> (B, Sq, H, Dv) in q's
    dtype. Each block of ``block_q`` query rows walks the key tiles of
    :func:`flash_kv_tiles` with an online softmax in base 2: the fp32 dot
    times ``fp32(Dh^-0.5) * fp32(log2 e)`` (the scale after the product),
    masked with NEG (keys past Skv are not in a tile, as if they scored
    -inf), ``p = exp2(s - m)`` added to l unrounded and rounded to v's
    dtype for the PV product, and ``O / max(l, 1e-30)`` at the end."""
    B, Sq, H, Dh = q.shape
    Skv, KVH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KVH
    scale = (torch.tensor(Dh ** -0.5, dtype=torch.float32)
             * torch.tensor(LOG2E, dtype=torch.float32)).item()
    kf, out = k.float(), torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, Sq, block_q):
        rows = min(block_q, Sq - q0)
        qb = q[:, q0:q0 + rows].float().reshape(B, rows, KVH, G, Dh)
        qpos = torch.arange(q0, q0 + rows, device=q.device)[:, None]
        m = torch.full((B, KVH, G, rows), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((B, KVH, G, rows, Dv), dtype=torch.float32, device=q.device)
        lo, hi = flash_kv_tiles(q0, Sq, Skv, causal, window, block_q, block_k)
        for t in range(lo, hi):
            k0, k1 = t * block_k, min((t + 1) * block_k, Skv)
            s = torch.einsum("bqkgd,bnkd->bkgqn", qb, kf[:, k0:k1]) * scale
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            valid = torch.ones((rows, k1 - k0), dtype=torch.bool, device=q.device)
            if causal:
                valid = valid & (kpos <= qpos)
            if window > 0:
                valid = valid & (kpos > qpos - window)
            s = torch.where(valid, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp2(s - m_new[..., None])
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum("bkgqn,bnkd->bkgqd", p.to(v.dtype).float(),
                                                   v[:, k0:k1].float())
            m = m_new
        o = o / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + rows] = o.permute(0, 3, 1, 2, 4).reshape(B, rows, H, Dv).to(q.dtype)
    return out


def split_layout(n_pages: int, kv_splits: int) -> tuple[int, int]:
    """``(S, pps)``: the split count clamped to ``[1, NP]`` and the pages
    per split, ``ceil(NP / S)`` (the last split may run past NP)."""
    S = max(1, min(int(kv_splits), n_pages))
    return S, -(-n_pages // S)


def paged_attention_split_ref(q, k_pages, v_pages, ptab, lens, *, kv_splits: int):
    """Per-split online-softmax partials, page by page, as the split kernel
    computes them.

    q (B, H, Dh); pools (P, ps, KVH, Dh/Dv); ptab (B, NP) int; lens (B,) int
    -> mid_o (B, KVH, S, G, Dv) fp32 (unnormalized), m and l (B, KVH, S, G, 1)
    fp32. Split s owns logical pages ``[s·pps, (s+1)·pps)``; a page takes
    part when ``page·ps < lens[b]``, and splits with no such page keep
    ``(0, NEG, 0)``. A page past the slot's last valid page reads that
    page's row (the tail clamp), and the table is never indexed at or past
    NP: a length over ``NP·ps`` re-reads row ``ptab[b, NP-1]``, as the
    gather clamps in the JAX package. The probabilities are rounded to the
    value dtype before the PV product; tokens at or past ``lens[b]`` add
    nothing.
    """
    B, H, Dh = q.shape
    _, ps, KVH, Dv = v_pages.shape
    NP = ptab.shape[1]
    G = H // KVH
    S, pps = split_layout(NP, kv_splits)
    dev = q.device
    lens = lens.to(device=dev, dtype=torch.int64)
    qf = q.float().reshape(B, KVH, G, Dh) * (Dh ** -0.5)
    last = torch.clamp((lens + ps - 1) // ps - 1, min=0)  # (B,) last valid page
    o = torch.zeros((B, KVH, S, G, Dv), dtype=torch.float32, device=dev)
    m = torch.full((B, KVH, S, G, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, S, G, 1), dtype=torch.float32, device=dev)
    b_idx = torch.arange(B, device=dev)[:, None]
    tok = torch.arange(ps, device=dev)
    for j in range(pps):
        page = torch.arange(S, device=dev) * pps + j  # (S,) logical page per split
        col = torch.minimum(torch.minimum(page[None], last[:, None]),
                            torch.tensor(NP - 1, device=dev))  # (B, S)
        rows = ptab.long()[b_idx, col]  # (B, S)
        k = k_pages[rows].float()  # (B, S, ps, KVH, Dh)
        v = v_pages[rows]
        kpos = page[:, None] * ps + tok  # (S, ps)
        valid = kpos[None] < lens[:, None, None]  # (B, S, ps)
        active = (page[None] * ps < lens[:, None])  # (B, S)
        sc = torch.einsum("bkgd,bspkd->bksgp", qf, k)
        vmask = valid[:, None, :, None, :]  # (B, 1, S, 1, ps)
        sc = torch.where(vmask, sc, NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        pr = torch.where(vmask, torch.exp(sc - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l_new = l * corr + pr.sum(dim=-1, keepdim=True)
        v = torch.where(valid[..., None, None], v, torch.zeros((), dtype=v.dtype,
                                                               device=dev))
        pv = torch.einsum("bksgp,bspkd->bksgd", pr.to(v.dtype).float(), v.float())
        act = active[:, None, :, None, None]  # (B, 1, S, 1, 1)
        o = torch.where(act, o * corr + pv, o)
        m = torch.where(act, m_new, m)
        l = torch.where(act, l_new, l)
    return o, m, l


def combine_splits_ref(mid_o, m, l):
    """LSE-corrected merge of split partials: mid_o (B, KVH, S, G, Dv), m and
    l (B, KVH, S, G, 1) -> (B, KVH, G, Dv) fp32. Only non-positive
    exponents are taken, so any spread of m is safe; an all-empty row
    (lens == 0) comes out 0."""
    m_max = m.amax(dim=2, keepdim=True)
    corr = torch.exp(m - m_max)
    l_tot = (l * corr).sum(dim=2)  # (B, KVH, G, 1)
    o_tot = (mid_o * corr).sum(dim=2)  # (B, KVH, G, Dv)
    return o_tot / torch.clamp(l_tot, min=1e-30)


def paged_attention_ref(q, k_pages, v_pages, ptab, lens):
    """The gather oracle: materialize each slot's logical K/V view and take
    a masked softmax. q (B, H, Dh) -> (B, H, Dv) in q's dtype; a slot with
    ``lens == 0`` gives 0."""
    B, H, Dh = q.shape
    _, ps, KVH, Dv = v_pages.shape
    G = H // KVH
    rows = ptab.long()
    gk = k_pages[rows].reshape(B, -1, KVH, Dh).float()  # (B, NP·ps, KVH, Dh)
    gv = v_pages[rows].reshape(B, -1, KVH, Dv).float()
    qf = q.float().reshape(B, KVH, G, Dh) * (Dh ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qf, gk)
    pos = torch.arange(gk.shape[1], device=q.device)
    valid = pos[None] < lens.to(q.device).long()[:, None]  # (B, NP·ps)
    s = torch.where(valid[:, None, None], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, gv)
    o = torch.where((lens.to(q.device) > 0)[:, None, None, None], o, 0.0)
    return o.reshape(B, H, Dv).to(q.dtype)
