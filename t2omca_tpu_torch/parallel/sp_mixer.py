"""The sequence-parallel mixer forward, ``ring_attention``'s consumer
(port of ``t2omca_tpu/parallel/sp_mixer.py``).

At config 5's scale (256 AGVs × 16 MECs) the mixer attends over 515
tokens (256 entities + 256 agents + 3); beyond that the ``(b, h, T, T)``
scores and the token activations outgrow one card. ``mixer_apply_sp``
runs the port's ``TransformerMixer`` forward (``models/mixer.py``) with
the token axis cut over placements (``parallel/ring_attention``):

* the tokens are built as the dense module builds them (Q12's obs
  entities without ``state_entity_mode``), padded to a multiple of the
  placement count, the padded keys masked out of every softmax;
* embedding, LayerNorm and the FFN are token-local and run on each
  placement's block; attention is ``ring_attention``, its keys pinned to
  the layer-0 token blocks at every depth, with the scale ``d**-0.25`` on
  both queries and keys (Q1) and post-LN residuals (Q2);
* the hypernet readout (Q11: the last 3 tokens and one per agent) and
  ``out_gate`` run after the output blocks are gathered.

It reads the mixer's own parameters (a placement on another card than the
mixer takes a copy of the ones it uses); dropout is off, as in JAX's
``mixer_apply_sp``.
"""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.mixer import TransformerMixer
from ..models.transformer import dense
from .mesh import Placement
from .ring_attention import gather, on, ring_attention, scatter


def _sp_transformer(mixer: TransformerMixer, tokens: List[torch.Tensor],
                    valid: List[torch.Tensor], places: Sequence[Placement]
                    ) -> List[torch.Tensor]:
    """The transformer stack on the token blocks ``tokens[j]`` ``(B, T_j,
    E)`` of ``places[j]``; ``valid[j]`` ``(T_j,)`` marks its real (not
    padding) tokens."""
    dt, heads = mixer.dtype, mixer.heads
    # the stack a placement reads: the mixer's own, or its copy on a card
    # of the placement's own
    tfs = [_on_device(mixer.transformer, p.device) for p in places]
    d = mixer.emb // heads if mixer.standard_heads else mixer.emb
    scale = d ** -0.25
    b = tokens[0].shape[0]
    k0, x = tokens, tokens
    masks = []
    for j, place in enumerate(places):
        with on(place):
            masks.append(valid[j][None, None, :].expand(
                b, heads, valid[j].shape[0]))

    def split(layer, z):
        t = z.shape[1]
        return dense(layer, z, dt).view(b, t, heads, d).transpose(1, 2)

    for i in range(mixer.depth):
        qs, ks, vs = [], [], []
        for j, place in enumerate(places):
            with on(place):
                blk_j = getattr(tfs[j], f"block_{i}")
                qs.append(split(blk_j.attention.toqueries, x[j]) * scale)
                ks.append(split(blk_j.attention.tokeys, k0[j]) * scale)
                vs.append(split(blk_j.attention.tovalues, k0[j]))
        ctx = ring_attention(qs, ks, vs, places, masks)
        out = []
        for j, place in enumerate(places):
            with on(place):
                blk_j = getattr(tfs[j], f"block_{i}")
                t = x[j].shape[1]
                c = ctx[j].transpose(1, 2).reshape(b, t, heads * d)
                attended = dense(blk_j.attention.unifyheads, c, dt)
                x1 = blk_j.norm1(attended + x[j])
                ff = torch.relu(dense(blk_j.ff1, x1, dt))
                ff = dense(blk_j.ff2, ff, dt)
                out.append(blk_j.norm2(ff + x1))
        x = out
    return x


def _on_device(module, device):
    """``module`` itself on its own device, else a copy on ``device``."""
    if next(module.parameters()).device == torch.device(device):
        return module
    return copy.deepcopy(module).to(device)


def mixer_apply_sp(mixer: TransformerMixer, qvals: torch.Tensor,
                   hidden_states: torch.Tensor,
                   hyper_weights: torch.Tensor, states: torch.Tensor,
                   obs: torch.Tensor, places: Sequence[Placement]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mixer(qvals, hidden_states, hyper_weights, states, obs)``
    (deterministic) with the token axis cut over ``places`` → ``(q_tot
    (b, 1, 1), hyper (b, 3, emb))`` f32 on the inputs' device."""
    b = qvals.shape[0]
    n = len(places)
    if mixer.state_entity_mode:
        inputs = states.reshape(b, mixer.n_entities, mixer.feat_dim)
    else:                                   # Q12: all agents' obs entities
        inputs = obs.reshape(b, mixer.n_agents * mixer.n_entities,
                             mixer.feat_dim)
    embs = dense(mixer.feat_embedding, inputs, mixer.dtype)
    tokens = torch.cat([embs, hidden_states.to(embs.dtype),
                        hyper_weights.to(embs.dtype)], dim=1)
    t = tokens.shape[1]
    tp = -(-t // n) * n
    tokens = F.pad(tokens, (0, 0, 0, tp - t))
    valid = torch.arange(tp, device=tokens.device) < t
    per = tp // n
    blocks = scatter(list(tokens.split(per, dim=1)), places)
    vblocks = scatter(list(valid.split(per)), places)
    outs = _sp_transformer(mixer, blocks, vblocks, places)
    out = torch.cat(gather(outs, places, tokens.device), dim=1)
    out = out[:, :t].float()
    a, e = mixer.n_agents, mixer.emb
    w1 = mixer.pos_func(out[:, -3 - a:-3, :])
    b1 = out[:, -3, :].reshape(b, 1, e)
    w2 = mixer.pos_func(out[:, -2, :].reshape(b, e, 1))
    b2 = torch.relu(dense(mixer.hyper_b2, out[:, -1, :],
                          torch.float32)).reshape(b, 1, 1)
    hidden = F.elu(torch.matmul(qvals.float(), w1) + b1)
    y = torch.matmul(hidden, w2) + b2
    if mixer.zero_init_gate:
        y = y * mixer.out_gate
    return y, out[:, -3:, :]
