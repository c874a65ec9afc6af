"""Query-slice forwards: compute only the rows that are read (port of the
agent and mixer sides of ``t2omca_tpu/ops/query_slice.py``).

An exact algebraic reduction of ``TransformerAgent.forward``. Keys are
pinned to layer 0 and only token 0 is read, so one query row is carried
through the stack and the key/value projections are folded away:

* ``logits_h = x0 (Wq_h Wk_hᵀ s²) k0ᵀ`` with ``Wqk_h`` folded once from
  the weights (``s = head_dim**-0.25``, Q1), so keys never exist;
* ``attended = Σ_h (attn_h k0) (Wv_h Wu_h)``, so values never exist.

Numerics mirror the JAX module: products take ``dtype`` inputs with f32
accumulation, LayerNorm statistics are f32 (fast variance, eps 1e-6),
softmax is f32 in the f32 mode and ``dtype`` otherwise. ``params`` are
the agent's state dict (``TransformerAgent`` names) or a
``fold_agent_params`` result. The mixer side carries the last
``n_agents + 3`` rows (w1 per agent, b1, w2, the b2 source and the 3
recurrent hyper tokens), with ``k0`` as both keys and values; under
autograd the flash kernel's Function returns ``dk`` and ``dv`` for that
one tensor and autograd sums them.

``agent_forward_qslice_entity`` is the entity-table acting forward: under
``obs_entity_mode`` + ``fast_norm`` every observer's token ``j`` is one of
two per-env embedded rows (entity ``j`` visible or masked) plus an
is-self correction on the diagonal, so logits and context contract
against ``(B, A, E)`` tables and the ``(B·A, A+1, E)`` keys never exist.
It is plain tensor code (JAX computes it outside any Pallas kernel), so
it launches no flash kernel. Noisy q-heads draw one factored-Gaussian
sample a call from an explicit threefry key (``_q_head``), which is not
the dense flax module's ``make_rng`` stream.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.attention import flash_attention
from ..models.mixer import qmix_pos_func
from ..models.noisy import noisy_weights
from ..models.transformer import LN_EPS

#: marker key of a pre-folded parameter tree
FOLDED = "__qslice_folded__"


def agent_qslice_eligible(cfg) -> bool:
    """The reduction needs a deterministic transformer stack (no dropout
    inside the blocks)."""
    return (cfg.model.use_qslice
            and cfg.agent == "transformer"
            and cfg.model.dropout == 0.0)


def entity_tables_eligible(cfg) -> bool:
    """Whether acting (and the learner's compact unroll) runs the entity
    tables: the query-slice agent, the entity observation mode, the
    batched normalizer (the sequential one gives each observer its own
    prefix statistics) and no entity-count override."""
    return (cfg.model.use_entity_tables
            and agent_qslice_eligible(cfg)
            and cfg.env_args.obs_entity_mode
            and cfg.env_args.fast_norm
            and cfg.model.n_entities_obs == 0)


def entity_store_eligible(cfg) -> bool:
    """Whether episodes store the compact entity observation
    (``CompactEntityObs``): the entity tables, a mixer that reads the
    state and not the obs, the ring on the device, and MEC ids that fit
    the stored int8."""
    return (cfg.replay.compact_entity_store
            and entity_tables_eligible(cfg)
            and cfg.env_args.state_entity_mode
            and not cfg.replay.buffer_cpu_only
            and cfg.env_args.mec_num <= 128)


def mixer_qslice_eligible(cfg) -> bool:
    """The mixer reduction needs the deterministic transformer mixer
    (only the last ``n_agents + 3`` output rows are read)."""
    return (cfg.model.use_qslice
            and cfg.mixer == "transformer"
            and cfg.model.dropout == 0.0)


def _mm32(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w`` over ``dtype``-rounded operands, accumulated in f32
    (``jnp.dot(..., preferred_element_type=f32)``)."""
    return torch.matmul(x.to(dtype).float(), w.to(dtype).float())


def _ln(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
        ) -> torch.Tensor:
    """f32 fast-variance LayerNorm over the last axis (flax-compatible)."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    inv = torch.rsqrt(var + LN_EPS)
    return (x32 - mean) * inv * scale + bias


def _fold_block(params: Dict[str, torch.Tensor], prefix: str, emb: int,
                heads: int, head_dim: int, dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ ``wqk (E, H·E)`` with the Q1 dual scaling folded in, and
    ``wvu (H·E, E)``; folded in f32, stored in ``dtype``."""
    at = prefix + "attention."
    # torch Linear weights are (out, in); the fold works on (in, out)
    wq = params[at + "toqueries.weight"].float().t()      # (E, H·D)
    wk = params[at + "tokeys.weight"].float().t()
    wv = params[at + "tovalues.weight"].float().t()
    wu = params[at + "unifyheads.weight"].float().t()     # (H·D, E)
    h, d, e = heads, head_dim, emb
    wq_h, wk_h, wv_h = (w.reshape(e, h, d) for w in (wq, wk, wv))
    wu_h = wu.reshape(h, d, e)
    wqk = torch.einsum("ehd,fhd->ehf", wq_h, wk_h) * (d ** -0.5)
    wvu = torch.einsum("ehd,hdf->hef", wv_h, wu_h)
    return (wqk.reshape(e, h * e).to(dtype),
            wvu.reshape(h * e, e).to(dtype))


def fold_transformer(params: Dict[str, torch.Tensor], *, emb: int,
                     heads: int, head_dim: int, depth: int, dtype,
                     prefix: str = "transformer.") -> dict:
    """Fold every block's attention projections once (O(params), outside
    any per-step loop)."""
    blocks = []
    for i in range(depth):
        p = f"{prefix}block_{i}."
        wqk, wvu = _fold_block(params, p, emb, heads, head_dim, dtype)
        sub = lambda name: {"weight": params[p + name + ".weight"],
                            "bias": params[p + name + ".bias"]}
        blocks.append({"wqk": wqk, "wvu": wvu,
                       "u_bias": params[p + "attention.unifyheads.bias"],
                       "n1": sub("norm1"), "n2": sub("norm2"),
                       "ff1": sub("ff1"), "ff2": sub("ff2")})
    return {FOLDED: True, "blocks": blocks}


def _block_tail(bp: dict, attended: torch.Tensor, x0_flat: torch.Tensor,
                dtype) -> torch.Tensor:
    """Q2 post-LN residuals + FFN with f32 statistics. ``attended (N, E)``
    f32, ``x0_flat (N, E)`` in the compute dtype."""
    x1 = _ln(attended + x0_flat.float(), bp["n1"]["weight"].float(),
             bp["n1"]["bias"].float())
    hid = _mm32(x1, bp["ff1"]["weight"].t(), dtype)
    hid = torch.relu(hid + bp["ff1"]["bias"].float())
    y = _mm32(hid, bp["ff2"]["weight"].t(), dtype)
    y = y + bp["ff2"]["bias"].float()
    x2 = _ln(y + x1, bp["n2"]["weight"].float(), bp["n2"]["bias"].float())
    return x2.to(dtype)


def transformer_rows(tf_folded: dict, k0: torch.Tensor, x0: torch.Tensor,
                     *, emb: int, heads: int, depth: int,
                     dtype=torch.float32, attn_impl: str = "xla"
                     ) -> torch.Tensor:
    """Carry ``R`` query rows ``x0 (S, R, E)`` through ``depth`` folded
    blocks against the pinned layer-0 keys ``k0 (S, T, E)`` → ``(S, R,
    E)`` f32. ``attn_impl="pallas"`` runs the sliced attention through
    the flash kernel as one head-free attention (batch S, H = 1, query
    axis R·H, ``k0`` as keys and values); ``"xla"`` is the plain path."""
    s, r, _ = x0.shape
    for i in range(depth):
        bp = tf_folded["blocks"][i]
        qp = _mm32(x0.reshape(s * r, emb), bp["wqk"], dtype)
        qp = qp.to(dtype).reshape(s, r * heads, emb)
        if attn_impl == "pallas":
            ctx = flash_attention(qp[:, None], k0[:, None],
                                  k0[:, None])[:, 0]          # (S, R·H, E)
        else:
            logits = torch.bmm(qp.float(),
                               k0.to(dtype).float().transpose(1, 2))
            if dtype == torch.float32:
                attn = torch.softmax(logits, dim=-1)
            else:
                attn = torch.softmax(logits.to(dtype), dim=-1)
            ctx = torch.bmm(attn.to(dtype).float(), k0.to(dtype).float())
        ctx = ctx.to(dtype).reshape(s * r, heads * emb)
        attended = _mm32(ctx, bp["wvu"], dtype) + bp["u_bias"].float()
        x0 = _block_tail(bp, attended, x0.reshape(s * r, emb),
                         dtype).reshape(s, r, emb)
    return x0.float()


def _q_head(qb: Dict[str, torch.Tensor], h_new: torch.Tensor,
            noise_key: Optional[torch.Tensor] = None,
            prng_impl: Optional[str] = None) -> torch.Tensor:
    """Q head on ``(S, E)`` f32 rows: dense ``q_basic`` (``weight``,
    ``bias``) or the noisy layer. ``noise_key=None`` takes the noisy
    layer's mu path; a ``(2,)`` key draws ONE factored-Gaussian sample of
    its weights for the whole call (``noisy_weights``)."""
    if "weight" in qb:
        return h_new @ qb["weight"].float().t() + qb["bias"].float()
    w, b = qb["weight_mu"].float(), qb["bias_mu"].float()
    if noise_key is not None:
        w, b = noisy_weights(w, qb["weight_sigma"].float(), b,
                             qb["bias_sigma"].float(), noise_key, prng_impl)
    return h_new @ w.t() + b


def fold_agent_params(params: dict, *, emb: int, heads: int, depth: int,
                      standard_heads: bool = False, dtype=torch.float32
                      ) -> dict:
    """Pre-fold an agent state dict for ``agent_forward_qslice`` (a
    folded tree passes through)."""
    if FOLDED in params:
        return params
    head_dim = emb // heads if standard_heads else emb
    qb = {k.split(".", 1)[1]: v for k, v in params.items()
          if k.startswith("q_basic.")}
    return {FOLDED: True,
            "fe": {"weight": params["feat_embedding.weight"],
                   "bias": params["feat_embedding.bias"]},
            "tf": fold_transformer(params, emb=emb, heads=heads,
                                   head_dim=head_dim, depth=depth,
                                   dtype=dtype),
            "qb": qb}


def agent_forward_qslice(params: dict, inputs: torch.Tensor,
                         hidden_state: torch.Tensor, *, n_entities: int,
                         feat_dim: int, emb: int, heads: int, depth: int,
                         n_actions: int, standard_heads: bool = False,
                         dtype=torch.float32,
                         noise_key: Optional[torch.Tensor] = None,
                         attn_impl: str = "xla",
                         prng_impl: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``TransformerAgent.forward``: inputs ``(B, A, obs)``,
    hidden ``(B, A, emb)`` → (q, hidden'), both f32. ``noise_key`` (and
    the run's ``prng_impl``) as in ``_q_head``."""
    f = fold_agent_params(params, emb=emb, heads=heads, depth=depth,
                          standard_heads=standard_heads, dtype=dtype)
    b, a, _ = inputs.shape
    s = b * a
    x = inputs.reshape(s, n_entities, feat_dim).to(dtype)
    h0 = hidden_state.reshape(s, emb).to(dtype)
    fe = f["fe"]
    embs = (_mm32(x, fe["weight"].t(), dtype)
            + fe["bias"].float()).to(dtype)                    # (S, N, E)
    k0 = torch.cat([h0[:, None, :], embs], dim=1)              # (S, T, E)
    out = transformer_rows(f["tf"], k0, h0[:, None, :], emb=emb,
                           heads=heads, depth=depth, dtype=dtype,
                           attn_impl=attn_impl)                # (S, 1, E)
    h_new = out[:, 0, :]
    q = _q_head(f["qb"], h_new, noise_key, prng_impl)
    return q.reshape(b, a, n_actions), h_new.reshape(b, a, emb)


def _bmm32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` over ``dtype`` operands, accumulated in f32 (the einsums
    with ``preferred_element_type=f32``: bf16 products are exact in
    f32)."""
    return torch.matmul(x.float(), y.float())


def agent_forward_qslice_entity(params: dict, rows: torch.Tensor,
                                same_mec: torch.Tensor, mean: torch.Tensor,
                                std: torch.Tensor,
                                hidden_state: torch.Tensor, *, emb: int,
                                heads: int, depth: int, n_actions: int,
                                standard_heads: bool = False,
                                dtype=torch.float32,
                                noise_key: Optional[torch.Tensor] = None,
                                prng_impl: Optional[str] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``agent_forward_qslice`` on the factored entity observation
    (``MultiAgvOffloadingEnv.compact_obs``): ``rows (B, A, 8)``,
    ``same_mec (B, A, A)`` bool, ``mean``/``std (B, A, 9)``, hidden ``(B,
    A, emb)`` → (q, hidden'), both f32. Agent ``i``'s token ``j`` is the
    normalized ``(same_mec[i, j] ? rows[j] : 0, i == j)``, so each env
    has a visible and a masked embedded row per entity plus an is-self
    correction ``we[8] / (std[j, 8] + 1e-8)`` on the diagonal. The bf16
    mode rounds where the JAX function does: the softmax in bf16, and
    each of the four context terms cast to bf16 before they are added."""
    f = fold_agent_params(params, emb=emb, heads=heads, depth=depth,
                          standard_heads=standard_heads, dtype=dtype)
    b, a, _ = rows.shape
    s = b * a
    # per-env embedding tables (feature 8 is is-self)
    denom = std.float() + 1e-8                                # (B, A, 9)
    rows9 = torch.cat([rows.float(), rows.new_zeros(b, a, 1,
                                                    dtype=torch.float32)],
                      dim=-1)
    nv = ((rows9 - mean) / denom).to(dtype)                   # visible
    nh = ((-mean) / denom).to(dtype)                          # masked
    we = f["fe"]["weight"].t().to(dtype)                      # (9, E)
    be = f["fe"]["bias"].float()
    e_vis = (_mm32(nv, we, dtype) + be).to(dtype)             # (B, A, E)
    e_hid = (_mm32(nh, we, dtype) + be).to(dtype)
    self_corr = (we[8].float() / denom[..., 8:9]).to(dtype)  # (B, A, E)

    h_tok = hidden_state.to(dtype)                            # (B, A, E)
    vis = same_mec.unsqueeze(2)                               # (B, A, 1, A)
    eye = torch.eye(a, device=rows.device).view(1, a, 1, a)
    x0 = h_tok
    for i in range(depth):
        bp = f["tf"]["blocks"][i]
        qp = _mm32(x0.reshape(s, emb), bp["wqk"], dtype)
        qp = qp.to(dtype).reshape(b, a, heads, emb)
        # logits against key 0 (the own hidden token) and the tables
        l0 = _bmm32(qp, h_tok.unsqueeze(-1))[..., 0]          # (B, A, H)
        qf = qp.reshape(b, a * heads, emb)
        lv = _bmm32(qf, e_vis.transpose(1, 2)).reshape(b, a, heads, a)
        lh = _bmm32(qf, e_hid.transpose(1, 2)).reshape(b, a, heads, a)
        ls = _bmm32(qp, self_corr.unsqueeze(-1))              # (B, A, H, 1)
        lent = torch.where(vis, lv, lh) + eye * ls
        logits = torch.cat([l0.unsqueeze(-1), lent], dim=-1)
        if dtype == torch.float32:
            attn = torch.softmax(logits, dim=-1)
        else:
            attn = torch.softmax(logits.to(dtype), dim=-1)
        attn = attn.to(dtype)
        a0, ae = attn[..., 0], attn[..., 1:]                  # (B, A, H[, A])
        av = ae * vis.to(dtype)
        ah = ae - av                                          # masked branch
        diag = ae.diagonal(dim1=1, dim2=3).transpose(1, 2)    # (B, A, H)
        ctx_v = _bmm32(av.reshape(b, a * heads, a), e_vis).to(dtype)
        ctx_h = _bmm32(ah.reshape(b, a * heads, a), e_hid).to(dtype)
        ctx = (a0.unsqueeze(-1) * h_tok.unsqueeze(2)
               + ctx_v.reshape(b, a, heads, emb)
               + ctx_h.reshape(b, a, heads, emb)
               + diag.unsqueeze(-1) * self_corr.unsqueeze(2))
        ctx = ctx.to(dtype).reshape(s, heads * emb)
        attended = _mm32(ctx, bp["wvu"], dtype) + bp["u_bias"].float()
        x0 = _block_tail(bp, attended, x0.reshape(s, emb),
                         dtype).reshape(b, a, emb)
    h_new = x0.float().reshape(s, emb)
    q = _q_head(f["qb"], h_new, noise_key, prng_impl)
    return q.reshape(b, a, n_actions), h_new.reshape(b, a, emb)


def fold_mixer_params(params: dict, *, emb: int, heads: int, depth: int,
                      standard_heads: bool = False, dtype=torch.float32
                      ) -> dict:
    """Pre-fold a mixer state dict for ``mixer_forward_qslice`` (a folded
    tree passes through). The fold is differentiable, so gradients reach
    the raw weights."""
    if FOLDED in params:
        return params
    head_dim = emb // heads if standard_heads else emb
    tree = {FOLDED: True,
            "fe": {"weight": params["feat_embedding.weight"],
                   "bias": params["feat_embedding.bias"]},
            "tf": fold_transformer(params, emb=emb, heads=heads,
                                   head_dim=head_dim, depth=depth,
                                   dtype=dtype),
            "hb": {"weight": params["hyper_b2.weight"],
                   "bias": params["hyper_b2.bias"]}}
    if "out_gate" in params:          # zero_init_gate configs
        tree["og"] = params["out_gate"]
    return tree


def mixer_forward_qslice(params: dict, qvals: torch.Tensor,
                         hidden_states: torch.Tensor,
                         hyper_weights: torch.Tensor, states: torch.Tensor,
                         obs: torch.Tensor, *, n_agents: int,
                         n_entities: int, feat_dim: int, emb: int,
                         heads: int, depth: int, pos_func: str,
                         pos_func_beta: float,
                         state_entity_mode: bool = True,
                         standard_heads: bool = False, dtype=torch.float32,
                         attn_impl: str = "xla"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``TransformerMixer.forward``: only the last
    ``n_agents + 3`` output rows are computed → ``(q_tot (b, 1, 1), hyper
    (b, 3, emb))``, both f32."""
    f = fold_mixer_params(params, emb=emb, heads=heads, depth=depth,
                          standard_heads=standard_heads, dtype=dtype)
    b = qvals.shape[0]
    if state_entity_mode:
        inputs = states.reshape(b, n_entities, feat_dim).to(dtype)
    else:                                   # Q12: all agents' obs entities
        inputs = obs.reshape(b, n_agents * n_entities, feat_dim).to(dtype)
    fe = f["fe"]
    embs = (_mm32(inputs, fe["weight"].t(), dtype)
            + fe["bias"].float()).to(dtype)
    k0 = torch.cat([embs, hidden_states.to(dtype), hyper_weights.to(dtype)],
                   dim=1)                                      # (b, T, E)
    r = n_agents + 3
    out = transformer_rows(f["tf"], k0, k0[:, -r:, :], emb=emb, heads=heads,
                           depth=depth, dtype=dtype,
                           attn_impl=attn_impl)                # (b, A+3, E)
    w1 = out[:, :n_agents, :]
    b1 = out[:, -3, :].reshape(b, 1, emb)
    w2 = out[:, -2, :].reshape(b, emb, 1)
    hb = f["hb"]
    b2 = torch.relu(out[:, -1, :] @ hb["weight"].float().t()
                    + hb["bias"].float()).reshape(b, 1, 1)
    w1 = qmix_pos_func(w1, pos_func, pos_func_beta)
    w2 = qmix_pos_func(w2, pos_func, pos_func_beta)
    hidden = torch.nn.functional.elu(torch.matmul(qvals.float(), w1) + b1)
    y = torch.matmul(hidden, w2) + b2
    if "og" in f:
        y = y * f["og"].float()
    return y, out[:, -3:, :]


def make_mixer_qslice(mixer):
    """(fold, apply) pair closing over a ``TransformerMixer``'s
    attributes; ``apply`` takes ``TransformerMixer.forward``'s positional
    arguments after the params. The mixer's ``attn_impl`` (the config's
    ``kernels.attention``) threads through: only the learner unroll uses
    this pair."""
    fold = lambda params: fold_mixer_params(
        params, emb=mixer.emb, heads=mixer.heads, depth=mixer.depth,
        standard_heads=mixer.standard_heads, dtype=mixer.dtype)
    apply = lambda mp, qvals, h, hyper, s, o: mixer_forward_qslice(
        mp, qvals, h, hyper, s, o, n_agents=mixer.n_agents,
        n_entities=mixer.n_entities, feat_dim=mixer.feat_dim, emb=mixer.emb,
        heads=mixer.heads, depth=mixer.depth, pos_func=mixer.qmix_pos_func,
        pos_func_beta=mixer.qmix_pos_func_beta,
        state_entity_mode=mixer.state_entity_mode,
        standard_heads=mixer.standard_heads, dtype=mixer.dtype,
        attn_impl=mixer.attn_impl)
    return fold, apply
