"""Sequence-parallel attention: ring attention and all-to-all (Ulysses)
(counterpart of heat_tpu/nn/attention.py).

Two strategies over a sequence split along ranks, both exact:

* **ring**: every rank holds one sequence block of Q, K, V; the K/V blocks
  travel around the ranks (one ``ring_shift`` a step) while an online
  softmax folds each visiting block into the output.  Memory per rank is
  O(seq/p) in the sequence, and no (seq x seq) score matrix is formed.
* **ulysses** (all-to-all): one ``all_to_all`` re-shards from sequence-split
  to head-split, each rank runs full-sequence attention on its heads, and a
  second ``all_to_all`` restores sequence sharding.  Needs ``heads % p ==
  0``.  With ``use_flash`` the local attention is the flash kernel
  (``nn/_flash.py``: ``csrc/flash_attn.cu`` on the card).

The JAX package's raw functions take global padded arrays under
``shard_map``; here, as everywhere in the port, each rank passes its own
padded chunk, and ``comm`` carries the exchange.  Products run in full
float32 (no TF32), as the JAX package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.dndarray import DNDarray
from ..core.linalg.basics import full_f32_matmul
from ..parallel.comm import Communication, sanitize_comm
from . import _flash

__all__ = ["scaled_dot_product_attention", "ring_attention", "ulysses_attention"]

_NEG_INF = -1e30


#: local attentions that the flash gate sent to the einsum path (a card
#: shape :func:`_flash.flash_unsupported` refuses)
EINSUM_ROUTES = 0


def _flash_route(q) -> str:
    """``"flash"`` or ``"einsum"`` for a local attention of (seq, heads,
    head_dim) tensors like ``q``: on the card the kernel takes float32 (the
    operands are cast to it) at the shapes :func:`_flash.flash_unsupported`
    admits; the CPU runs the kernel's plain version at every shape."""
    if q.device.type == "cuda" and _flash.flash_unsupported(*q.shape, torch.float32) is not None:
        return "einsum"
    return "flash"


def _local_flash(q, k, v, scale, causal, n_true):
    """Full-sequence attention of (seq, heads, head_dim) tensors through the
    flash kernel, in float32 as the JAX package casts for it, the result in
    q's dtype; padded tail positions (>= n_true) are isolated as their own
    segment, so real tokens never attend padding.  The caller runs it where
    :func:`_flash_route` chooses ``"flash"``."""
    if q.dtype == k.dtype == v.dtype == torch.float32:
        return _flash.flash_attention(q, k, v, scale, causal, n_true)
    out = _flash.flash_attention(q.float(), k.float(), v.float(), scale, causal, n_true)
    return out.to(q.dtype)


def _block_attn_update(o, m, l, q, k, v, q_off, k_off, scale, causal, n_true):
    """Fold one K/V block into the running (output, max, denom) triple.

    Flash-attention online softmax: scores are computed in f32, the running
    max ``m`` and denominator ``l`` are rescaled as new blocks arrive.
    ``q_off``/``k_off`` are the global positions of the local blocks,
    needed for causal masking and for masking the padded tail rows (global
    index >= n_true).  The (h, sq, sk) scores are masked and exponentiated
    in place, so one such tensor is held at a time; none of those in-place
    steps overwrites a tensor that autograd keeps, so the update is
    differentiable in q, k and v.
    """
    sq, h, d = q.shape
    sk = k.shape[0]
    with full_f32_matmul():
        scores = torch.einsum("qhd,khd->hqk", q, k.float()).mul_(scale)
    k_pos = k_off + torch.arange(sk, device=q.device)
    mask = (k_pos < n_true)[None, None, :]
    if causal:
        q_pos = q_off + torch.arange(sq, device=q.device)
        mask = mask & (k_pos[None, None, :] <= q_pos[None, :, None])
    scores.masked_fill_(~mask, _NEG_INF)
    # the running max only steadies the exponentials: the result does not
    # depend on it, so it carries no gradient
    m_new = torch.maximum(m, scores.detach().amax(dim=-1))  # (h, sq)
    corr = torch.exp(m - m_new)
    # rows whose every key so far is masked have m_new == _NEG_INF; their
    # base is 0, so exp(scores - base) underflows to exactly 0 and a
    # fully-masked block contributes nothing regardless of arrival order
    base = torch.where(m_new == _NEG_INF, torch.zeros_like(m_new), m_new)
    p_block = scores.sub_(base[..., None]).exp_()  # (h, sq, sk)
    l_new = l * corr + p_block.sum(dim=-1)
    with full_f32_matmul():
        pv = torch.einsum("hqk,khd->qhd", p_block, v.float())
    o_new = o * corr.T[..., None] + pv
    return o_new, m_new, l_new


def _ring_body(q, k, v, *, comm: Communication, scale, causal, n_true, block):
    """One rank's part of the ring: its block of q, and the K/V blocks as
    they come round."""
    p = comm.size
    idx = comm.rank
    sq, h, d = q.shape
    qf = q.float()
    o = torch.zeros((sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((h, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((h, sq), dtype=torch.float32, device=q.device)
    q_off = idx * block
    for step in range(p):
        src = (idx - step) % p  # owner of the K/V block currently held
        o, m, l = _block_attn_update(o, m, l, qf, k, v, q_off, src * block, scale, causal, n_true)
        if step != p - 1:
            k = comm.ring_shift(k)
            v = comm.ring_shift(v)
    return (o / torch.clamp(l, min=1e-30).T[..., None]).to(q.dtype)


def _padded_seq(q, comm: Communication) -> int:
    """The global padded sequence length: the ranks' blocks added up.  A
    rank whose block differs from the others' would stall the exchange, so
    it counts as a sequence that does not divide the mesh."""
    blocks = comm.all_gather(torch.tensor([q.shape[0]], dtype=torch.int64, device=q.device))
    seq = int(blocks.sum())
    if seq % comm.size or bool((blocks != q.shape[0]).any()):
        raise ValueError(f"padded sequence {seq} must divide the mesh size {comm.size}")
    return seq


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    comm: Optional[Communication] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    n_true: Optional[int] = None,
) -> torch.Tensor:
    """Exact attention over a sequence sharded around the ranks.

    ``q``/``k``/``v`` are this rank's padded chunks, (block, heads,
    head_dim), every rank's block of one length; the global padded sequence
    is ``block * comm.size`` (the pad-and-mask layer guarantees this for
    DNDarray inputs; raw callers pass padded chunks plus ``n_true``, the
    true global length).  Returns this rank's chunk of the output,
    differentiable in q, k and v across the ranks (``ring_shift`` carries the
    gradient back round the ring), as ``jax.grad`` through the JAX
    package's ``shard_map`` is.
    """
    comm = sanitize_comm(comm)
    seq = _padded_seq(q, comm)
    d = q.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    n_true = seq if n_true is None else n_true
    block = seq // comm.size
    return _ring_body(q, k, v, comm=comm, scale=float(scale), causal=bool(causal), n_true=int(n_true), block=block)


def _ulysses_body(q, k, v, *, comm, scale, causal, n_true, use_flash):
    """all_to_all seq->heads, local attention, reverse."""
    # (block, h, d) -> (seq, h/p, d): gather sequence, scatter heads
    qg = comm.all_to_all(q, split_axis=1, concat_axis=0)
    kg = comm.all_to_all(k, split_axis=1, concat_axis=0)
    vg = comm.all_to_all(v, split_axis=1, concat_axis=0)
    seq = qg.shape[0]
    if use_flash and _flash_route(qg) == "flash":
        # each rank now holds the FULL sequence for h/p heads, the shape
        # the flash kernel takes; the (h/p, seq, seq) scores of the einsum
        # path are never formed
        og = _local_flash(qg, kg, vg, scale, causal, n_true)
    else:
        if use_flash:
            global EINSUM_ROUTES
            EINSUM_ROUTES += 1
        with full_f32_matmul():
            scores = torch.einsum("qhd,khd->hqk", qg.float(), kg.float()).mul_(scale)
        k_pos = torch.arange(seq, device=q.device)
        mask = (k_pos < n_true)[None, None, :]
        if causal:
            mask = mask & (k_pos[None, None, :] <= k_pos[None, :, None])
        weights = torch.softmax(scores.masked_fill_(~mask, _NEG_INF), dim=-1)
        del scores  # one (h/p, seq, seq) tensor at a time
        with full_f32_matmul():
            og = torch.einsum("hqk,khd->qhd", weights, vg.float()).to(q.dtype)
    # (seq, h/p, d) -> (block, h, d)
    return comm.all_to_all(og, split_axis=0, concat_axis=1)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    comm: Optional[Communication] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    n_true: Optional[int] = None,
    use_flash: bool = False,
) -> torch.Tensor:
    """Exact attention via all-to-all sequence parallelism (Ulysses style).

    ``q``/``k``/``v`` are this rank's padded chunks, as for
    :func:`ring_attention`.  ``use_flash=True`` runs the local
    full-sequence attention through the flash kernel: the (h/p, seq, seq)
    score tensor never materialises.  The kernel stays in exact float32.
    Differentiable in q, k and v: the all-to-alls carry the gradient back,
    and with ``use_flash`` the flash kernel's backward
    (``csrc/flash_attn_bwd.cu`` on the card) computes it.
    """
    comm = sanitize_comm(comm)
    seq = _padded_seq(q, comm)
    h, d = q.shape[1:]
    if h % comm.size:
        raise ValueError(f"ulysses needs heads ({h}) divisible by the mesh size ({comm.size})")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    n_true = seq if n_true is None else n_true
    return _ulysses_body(q, k, v, comm=comm, scale=float(scale), causal=bool(causal), n_true=int(n_true),
                         use_flash=bool(use_flash))


def scaled_dot_product_attention(
    q: DNDarray,
    k: DNDarray,
    v: DNDarray,
    causal: bool = False,
    scale: Optional[float] = None,
    method: str = "ring",
) -> DNDarray:
    """DNDarray-level exact attention over the sequence-split axis.

    Inputs are (seq, heads, head_dim) DNDarrays, all with the same split:
    ``split=0`` runs the distributed strategy chosen by ``method``
    ("ring", "ulysses", or its alias "alltoall"; "flash" is Ulysses with the
    flash kernel); ``split=None`` computes locally, through the flash kernel
    for "flash".

    DNDarrays carry no gradient, here as in the JAX package (whose DNDarray
    is no pytree): to differentiate, call :func:`ring_attention` or
    :func:`ulysses_attention` on this rank's tensors.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, DNDarray):
            raise TypeError(f"{name} must be a DNDarray, got {type(t)}")
        if t.ndim != 3:
            raise ValueError(f"{name} must be (seq, heads, head_dim), got {t.ndim}-D")
    if not (q.split == k.split == v.split):
        raise ValueError(f"q/k/v must share a split, got {q.split}/{k.split}/{v.split}")
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError("q/k/v must have identical shapes (self-attention blocks)")

    seq, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale

    if method not in ("ring", "ulysses", "alltoall", "flash"):
        raise ValueError(
            f'method must be "ring", "ulysses", "alltoall" or "flash", got {method!r}'
        )

    if q.split is None:
        qd, kd, vd = q._dense(), k._dense(), v._dense()
        if method == "flash":
            if _flash_route(qd) == "flash":
                return DNDarray.from_dense(_local_flash(qd, kd, vd, scale, causal, seq), None, q.device, q.comm)
            global EINSUM_ROUTES
            EINSUM_ROUTES += 1
        wide = torch.promote_types(torch.float32, kd.dtype)
        with full_f32_matmul():
            scores = torch.einsum("qhd,khd->hqk", qd.to(wide), kd.to(wide)).mul_(scale)
        if causal:
            pos = torch.arange(seq, device=qd.device)
            scores.masked_fill_(pos[None, None, :] > pos[None, :, None], _NEG_INF)
        weights = torch.softmax(scores, dim=-1)
        del scores  # one (h, seq, seq) tensor at a time
        with full_f32_matmul():
            out = torch.einsum("hqk,khd->qhd", weights, vd.to(wide))
        return DNDarray.from_dense(out.to(qd.dtype), None, q.device, q.comm)
    if q.split != 0:
        raise ValueError(f"attention is sequence-parallel over split=0, got split={q.split}")

    # "flash" on a split sequence = Ulysses re-sharding with the flash
    # local kernel (each rank gets the full sequence for its heads)
    if method == "ring":
        out_padded = ring_attention(
            q.larray_padded, k.larray_padded, v.larray_padded,
            comm=q.comm, causal=causal, scale=scale, n_true=seq,
        )
    else:
        out_padded = ulysses_attention(
            q.larray_padded, k.larray_padded, v.larray_padded,
            comm=q.comm, causal=causal, scale=scale, n_true=seq,
            use_flash=(method == "flash"),
        )
    return q._like(out_padded)
