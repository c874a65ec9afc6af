"""Sequence parallelism: ring attention and Ulysses all-to-all over
placements (port of ``t2omca_tpu/parallel/ring_attention.py``).

The token axis of attention is cut into n blocks, block ``j`` on
placement ``j`` (``parallel/mesh.Placement``: a device and the CUDA stream
its work is enqueued on; ``sp_placements``), so that no placement holds
the whole ``T × T`` score matrix:

* ``ring_attention``: each placement keeps its query block while the K/V
  blocks and their masks rotate n times around the ring (placement ``j``
  takes the block of ``j + 1``, JAX's ``ppermute`` pulling from the
  right), the softmax accumulated online in float32 (running max ``m``
  and normalizer ``l``) with JAX's double-``where`` guard for rows that
  are all masked so far; the output divides by ``max(l, 1e-30)``;
* ``ulysses_attention``: two all-to-all reshards, tokens → heads before a
  dense float32 softmax attention over the whole sequence for a placement's
  share of the heads, heads → tokens after (the heads divide by n).

Where JAX runs one SPMD program under ``shard_map``, the port runs one
thread that enqueues every placement's work on that placement's stream:
a block handed to another placement is copied to its device, or handed
over by reference when the two share a card, after the receiving stream
waits for a CUDA event recorded where the block was made (the receiving
stream is recorded on the block for the caching allocator). One autograd
graph then spans the placements, and the gradient flows back through the
hand-overs, each backward op on its forward op's stream. (A thread a
placement with barriers would deadlock in the backward: autograd runs
the backward on one worker thread per CUDA device.) On the CPU every
placement is the CPU and the work runs in order. The products are
``torch.einsum``, as JAX computes them with XLA ops: no Pallas kernel
stands behind either scheme.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List, Optional, Sequence

import torch

from .mesh import Placement


def sp_placements(n: int, device=None, share_cards: bool = False
                  ) -> tuple:
    """n placements for the token blocks: the CPU n times (no streams), or
    n CUDA cards, or with ``share_cards`` n streams of card 0 (``device``
    as ``partition_devices``' one device: None or ``"cuda"`` for the
    visible cards)."""
    from ..device import resolve_device
    if n < 1:
        raise ValueError(f"sequence parallelism needs n >= 1, got {n}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (Placement(dev),) * n
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    if share_cards:
        cards = [dev] * n
    elif len(cards) < n:
        raise ValueError(f"sequence parallelism over {n} placements needs "
                         f"{n} cards, have {len(cards)} (share_cards puts "
                         f"each placement on its own stream of one card)")
    return tuple(Placement(d, torch.cuda.Stream(d)) for d in cards[:n])


def on(place: Placement):
    """The placement's stream as the current stream (nothing on the
    CPU)."""
    return (torch.cuda.stream(place.stream) if place.stream is not None
            else nullcontext())


def hand(x: torch.Tensor, src: Placement, dst: Placement) -> torch.Tensor:
    """``x``, made by ``src``'s work enqueued so far, for ``dst``'s work
    from now on: ``dst``'s stream waits for an event on ``src``'s, then
    takes ``x`` by reference on the same device (recording its stream on
    it) or as a copy on its own device."""
    if src.stream is not None and src.stream is not dst.stream:
        event = torch.cuda.Event()
        event.record(src.stream)
        dst.stream.wait_event(event)
    with on(dst):
        y = x.to(dst.device)
        if y is x and dst.stream is not None:
            x.record_stream(dst.stream)
    return y


def caller(device) -> Placement:
    """The calling code's placement on ``device``: its current stream."""
    device = torch.device(device)
    return Placement(device, torch.cuda.current_stream(device)
                     if device.type == "cuda" else None)


def scatter(blocks: Sequence[torch.Tensor], places: Sequence[Placement]
            ) -> List[torch.Tensor]:
    """Blocks made by the calling code → block ``j`` on ``places[j]``
    (``hand``)."""
    return [hand(b, caller(b.device), p) for b, p in zip(blocks, places)]


def gather(blocks: Sequence[torch.Tensor], places: Sequence[Placement],
           device) -> List[torch.Tensor]:
    """Each placement's block → the calling code's, on ``device``."""
    home = caller(device)
    return [hand(b, p, home) for b, p in zip(blocks, places)]


def online_block(q, k_blk, v_blk, o, l, m, mask_blk):
    """Accumulate one K/V block into the running softmax state ``(o, l,
    m)`` (JAX's ``_online_block``): q ``(..., Tq, D)``, blocks ``(..., Tk,
    D)``, ``mask_blk (..., Tk)`` the valid keys, all float32."""
    logits = torch.einsum("...qd,...kd->...qk", q, k_blk)
    logits = torch.where(mask_blk[..., None, :], logits, float("-inf"))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    # rows all masked so far have m == m_new == -inf; the inner where
    # keeps exp's argument finite, so the untaken branch (whose gradient
    # autograd still computes) never makes exp(-inf + inf) = NaN
    neg = m_new == float("-inf")
    alpha = torch.where(neg, 0.0, torch.exp(torch.where(neg, 0.0, m - m_new)))
    negq = neg[..., None]
    p = torch.where(negq, 0.0, torch.exp(
        torch.where(negq, 0.0, logits - m_new[..., None])))
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("...qk,...kd->...qd", p,
                                                v_blk)
    return o_new, l_new, m_new


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], places: Sequence[Placement],
                   kv_masks: Optional[Sequence[torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
    """Exact softmax attention with the token axis cut into the blocks
    ``qs[j], ks[j], vs[j]`` ``(..., T_j, D)`` on ``places[j]`` (made by its
    stream's work: ``scatter``) → each placement's output block, in its
    dtype (``gather`` brings them back). ``kv_masks[j]`` ``(...,
    T_j)`` bool marks the valid keys of block ``j`` (padding of a token
    count the placements do not divide); None: every key."""
    n = len(places)
    if not len(qs) == len(ks) == len(vs) == n:
        raise ValueError(f"{n} placements need {n} blocks each of q, k "
                         f"and v, got {len(qs)}, {len(ks)}, {len(vs)}")
    state, blocks = [], []
    for j, place in enumerate(places):
        with on(place):
            q = qs[j].float()
            o = torch.zeros_like(q)
            l = torch.zeros(q.shape[:-1], device=q.device)
            state.append([q, o, l, torch.full_like(l, float("-inf"))])
            mask = (torch.ones(ks[j].shape[:-1], dtype=torch.bool,
                               device=ks[j].device) if kv_masks is None
                    else kv_masks[j])
            blocks.append((ks[j], vs[j], mask))
    for step in range(n):
        for j, place in enumerate(places):
            with on(place):
                q, o, l, m = state[j]
                kb, vb, mb = blocks[j]
                state[j][1:] = online_block(q, kb.float(), vb.float(), o, l,
                                            m, mb)
        if step + 1 < n:
            # placement j takes the blocks of j + 1 (JAX: pull from the
            # right), each handed over after its last reader
            blocks = [tuple(hand(x, places[(j + 1) % n], places[j])
                            for x in blocks[(j + 1) % n])
                      for j in range(n)]
    out = []
    for j, place in enumerate(places):
        with on(place):
            _, o, l, _ = state[j]
            out.append((o / torch.clamp(l, min=1e-30)[..., None])
                       .to(qs[j].dtype))
    return out


def ulysses_attention(qs: Sequence[torch.Tensor],
                      ks: Sequence[torch.Tensor],
                      vs: Sequence[torch.Tensor],
                      places: Sequence[Placement]) -> List[torch.Tensor]:
    """Exact softmax attention by head ↔ token resharding
    (DeepSpeed-Ulysses): blocks ``(B, T_j, H, D)`` on ``places[j]``, ``H``
    divisible by the placement count → each placement's output block
    ``(B, T_j, H, D)`` (``scatter``, ``gather``). Placement ``j`` gathers
    every token block's heads
    ``j·H/n … (j+1)·H/n``, attends over the whole sequence in float32, and
    the outputs go back to their token blocks."""
    n = len(places)
    h = qs[0].shape[2]
    if h % n:
        raise ValueError(f"ulysses needs heads divisible by the placement "
                         f"count, got {h} heads over {n}")
    hn = h // n

    def heads(xs, j):
        """Placement j's heads of every token block, on j."""
        parts = [hand(x[:, :, j * hn:(j + 1) * hn], places[i], places[j])
                 for i, x in enumerate(xs)]
        with on(places[j]):
            return torch.cat(parts, dim=1)

    outs = []
    for j, place in enumerate(places):
        qf, kf, vf = heads(qs, j), heads(ks, j), heads(vs, j)
        with on(place):
            logits = torch.einsum("bqhd,bkhd->bhqk", qf.float(), kf.float())
            attn = torch.softmax(logits, dim=-1)
            outs.append(torch.einsum("bhqk,bkhd->bqhd", attn, vf.float())
                        .to(qs[j].dtype))
    sizes = [x.shape[1] for x in qs]
    starts = [sum(sizes[:i]) for i in range(n)]
    result = []
    for i, place in enumerate(places):
        parts = [hand(outs[j][:, starts[i]:starts[i] + sizes[i]], places[j],
                      place) for j in range(n)]
        with on(place):
            result.append(torch.cat(parts, dim=2))
    return result
