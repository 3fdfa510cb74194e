"""Model forward and loss on one device (``repro.models.transformer`` at
q = r = 1).

The training path of every family: the token embedding, whisper's encoder
over its stub frames (``enc_pos`` added, a non-causal ``("attn", "mlp")``
stack, ``enc_final_norm``) feeding every decoder layer's cross attention,
pixtral's projected patch embeddings at the first positions, the layer
stack over the pattern groups (each group recomputed in the backward when
``remat``, as the JAX stack's ``jax.checkpoint`` does), the final norm,
and the chunked cross-entropy.  Every grid collective of the JAX code is
the identity on one device: the embedding's row reduce-scatter, the K/V
``fcollect`` of cross attention, the loss's column max and sums, the row
and data sums of the loss.

Parameters are the port's global tree (:mod:`repro_torch.models.params`).
A leaf stacked over the G layer groups is read one group at a time
(``leaf[g]``), so the train step may pass, in place of a stacked tensor,
a list of its G per-group views (:mod:`repro_torch.train.step`).

With a ``pctx`` on a grid of PE processes in the blocked layout
(:func:`repro_torch.train.step.make_pctx`) ``forward``, ``loss_fn`` and
what they call are the JAX functions on one PE's blocks
(``shard_params(..., storage=)``): the embedding looked up against this
PE's vocabulary block and reduce-scattered over the sequence
(:func:`embed_tokens_grid`), the residual stream entering the skewed
layout under cannon_opt, every layer's grid form (``attention_block_grid``,
the sequence-sharded ``mamba_block``, the grid ``moe_block``, the grid
``mlp_apply``), and the chunked cross-entropy over the column-sharded
vocabulary (:func:`lm_loss_grid`) summed over the rows.  Without one
(``pctx`` None) nothing of the above runs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    set_checkpoint_early_stop)

from repro_torch.core.cannon import skew_activation
from repro_torch.models.attention import (attention_block,
                                          attention_block_grid,
                                          cross_attention_block)
from repro_torch.models.config import ModelConfig, attn_static
from repro_torch.models.layers import (ParallelContext, apply_norm,
                                       col_slice, dense, mlp_apply,
                                       row_slice_tokens)
from repro_torch.models.moe import moe_block
from repro_torch.models.ssm import mamba_block


def _grad_on(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    """tokens (B, S) -> x (B, S, D) in ``compute_dtype``: ids outside
    ``[0, V)`` (the -1 the JAX pipeline puts at patch positions) embed as
    zeros."""
    V = embed.shape[0]
    hit = (tokens >= 0) & (tokens < V)
    part = F.embedding(torch.clamp(tokens, 0, V - 1).long(), embed)
    return torch.where(hit[..., None], part,
                       torch.zeros((), dtype=part.dtype, device=part.device)
                       ).to(compute_dtype)


def embed_tokens_grid(pctx: ParallelContext, embed: torch.Tensor,
                      tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """tokens (B, S) on every PE -> x (B, S/q, D/r) blocked: each PE looks
    every position up against its (V/q, D/r) table block (ids outside it
    zero), then one row reduce-scatter sums over the vocabulary blocks and
    scatters the sequence (``repro/models/transformer.py:204-219``)."""
    V_loc = embed.shape[0]
    i, _ = pctx.grid.my_coords()
    loc = tokens.long() - i * V_loc
    hit = (loc >= 0) & (loc < V_loc)
    part = F.embedding(torch.clamp(loc, 0, V_loc - 1), embed)
    part = torch.where(hit[..., None], part,
                       torch.zeros((), dtype=part.dtype, device=part.device)
                       ).to(compute_dtype)
    return pctx.grid.reduce_scatter_rows(part, axis=1)


def lm_loss_grid(pctx: ParallelContext, lm_head: torch.Tensor,
                 x: torch.Tensor, labels: torch.Tensor, vocab: int,
                 chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked cross-entropy on one PE (``repro/models/transformer.
    py:222-259``): x (B, S_loc, D_loc) in the residual layout, labels
    (B, S) whole (this PE's ``row_slice_tokens`` are read), ``lm_head``
    this PE's block of the padded vocabulary.  Per chunk the logits are
    the strategy's GEMM in fp32, the log-sum-exp takes the column max
    (``pmax_cols``) and the column sum of its exponentials, the target
    logit its column sum (both sums ride one ``psum_cols``).  Columns at
    or past ``vocab`` (the zero padding a tree of ``vocab`` columns gets)
    are left out of the log-sum-exp; labels outside the padded vocabulary
    are masked.  With autograd on the chunks are not recomputed (the JAX
    loss's ``jax.checkpoint`` per chunk gives the same values), so no
    collective of the loss runs twice.  Returns (this row's summed token losses, its valid
    labels), both fp32."""
    B, S_loc, _ = x.shape
    grid = pctx.grid
    labels_loc = row_slice_tokens(pctx, labels, axis=1)
    V_loc = lm_head.shape[-1]
    vpad = V_loc * pctx.r
    _, j = grid.my_coords()
    nchunk = max(1, S_loc // min(chunk, S_loc))
    cs = S_loc // nchunk
    cols = j * V_loc + torch.arange(V_loc, device=x.device)
    pad = cols >= vocab if vocab < vpad else None
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nchunk):
        xs = x[:, c * cs:(c + 1) * cs]
        ls = labels_loc[:, c * cs:(c + 1) * cs].long()
        logits = dense(pctx, xs, lm_head, out_dtype=torch.float32)
        if pad is not None:
            logits = logits.masked_fill(pad, float("-inf"))
        # the shift takes no gradient (``pmax_cols_sg``'s zero tangent)
        m = grid.pmax_cols(torch.amax(logits, dim=-1))
        loc = ls - j * V_loc
        hit = (loc >= 0) & (loc < V_loc)
        tgt = torch.gather(logits, -1, torch.clamp(loc, 0, V_loc - 1)
                           [..., None])[..., 0]
        both = grid.psum_cols(torch.stack([
            torch.sum(torch.exp(logits - m[..., None]), dim=-1),
            torch.where(hit, tgt, torch.zeros_like(tgt))]))
        lse = torch.log(both[0]) + m
        valid = (ls >= 0) & (ls < vpad)
        tok = torch.where(valid, lse - both[1], torch.zeros_like(lse))
        total = total + torch.sum(tok)
        n = n + torch.sum(valid).float()
    return total, n


def _chunk_ce(xs: torch.Tensor, ls: torch.Tensor, lm_head: torch.Tensor
              ) -> torch.Tensor:
    """Summed token losses of one chunk: fp32 logits (the bf16 product
    accumulated in fp32, as the JAX ``dense(..., out_dtype=float32)``),
    the log-sum-exp shifted by its max (no gradient through the shift, as
    ``pmax_cols_sg``), ``lse - logit[label]``, labels outside the padded
    vocab masked."""
    vpad = lm_head.shape[1]
    logits = torch.matmul(xs.float(), lm_head.float())       # (B, cs, V)
    m = torch.amax(logits, dim=-1).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1)) + m
    tgt = torch.gather(logits, -1, torch.clamp(ls, 0, vpad - 1).long()
                       [..., None])[..., 0]
    valid = (ls >= 0) & (ls < vpad)
    tok = torch.where(valid, lse - tgt, torch.zeros_like(lse))
    return torch.sum(tok)


def lm_loss(lm_head: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
            chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked cross-entropy: x (B, S, D), labels (B, S) already shifted
    (-100 masks).  Returns (sum of token losses fp32, number of valid
    labels int32); the caller averages.  The positions go in
    ``S // min(chunk, S)`` chunks of ``S // nchunk`` (positions past
    ``nchunk * cs`` are not counted, as in the JAX loss), each chunk's
    logits recomputed in the backward so they never all live."""
    S = x.shape[1]
    nchunk = max(1, S // min(chunk, S))
    cs = S // nchunk
    vpad = lm_head.shape[1]
    remat = _grad_on(x, lm_head)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(nchunk):
        xs = x[:, i * cs:(i + 1) * cs]
        ls = labels[:, i * cs:(i + 1) * cs]
        total = total + (checkpoint(_chunk_ce, xs, ls, lm_head,
                                    use_reentrant=False)
                         if remat else _chunk_ce(xs, ls, lm_head))
        n = n + torch.sum((ls >= 0) & (ls < vpad)).to(torch.int32)
    return total, n


def layer_params(entry: Dict[str, Any], g: int) -> Dict[str, Any]:
    """One pattern position's parameters for layer group g."""
    return {part: {name: leaf[g] for name, leaf in leaves.items()}
            for part, leaves in entry.items()}


def apply_layer(cfg: ModelConfig, mixer: str, ffn: str, p: Dict,
                x: torch.Tensor, cross: Optional[torch.Tensor] = None,
                pctx: Optional[ParallelContext] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One (mixer, ffn) layer; returns (x, metrics).  ``cross`` is the
    encoder output that a decoder layer holding ``cross`` weights attends
    to, after its mixer.  With a blocked grid ``pctx``, every block's grid
    form on this PE's blocks."""
    metrics: Dict[str, torch.Tensor] = {}
    h = apply_norm(cfg, p["norm1"], x, pctx)
    if mixer == "attn":
        h = attention_block(p["mixer"], h, attn_static(cfg)) if pctx is None \
            else attention_block_grid(pctx, p["mixer"], h, attn_static(cfg))
    elif mixer == "mamba":
        h = mamba_block(p["mixer"], h, cfg, pctx)
    else:
        raise ValueError(mixer)
    x = x + h
    if cross is not None and "cross" in p:
        h = apply_norm(cfg, p["norm_cross"], x)
        x = x + cross_attention_block(p["cross"], h, cross,
                                      attn_static(cfg, causal=False))
    if ffn == "mlp":
        x = x + mlp_apply(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x, pctx),
                          pctx)
    elif ffn == "moe":
        y, metrics = moe_block(p["ffn"], apply_norm(cfg, p["norm2"], x, pctx),
                               cfg, pctx)
        x = x + y
    elif ffn != "none":
        raise ValueError(ffn)
    return x, metrics


def stack_forward(cfg: ModelConfig, layers_p: list, x: torch.Tensor,
                  remat: bool = False, cross: Optional[torch.Tensor] = None,
                  pctx: Optional[ParallelContext] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the layer groups in order; returns (x, summed ``moe_aux``).
    With ``remat`` each group is recomputed in the backward (on a grid in
    whole, collectives included, as ``jax.checkpoint`` does); ``cross``
    is the encoder output the decoder layers attend to; ``pctx`` a
    blocked grid (:func:`apply_layer`)."""
    pattern = cfg.pattern()

    def group(g, x, cross):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos, (mixer, ffn) in enumerate(pattern):
            x, metrics = apply_layer(cfg, mixer, ffn,
                                     layer_params(layers_p[pos], g), x, cross,
                                     pctx)
            if "moe_aux" in metrics:
                aux = aux + metrics["moe_aux"]
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # on a grid the recompute re-runs the group's collectives: it runs
    # the whole group (no early stop), so every PE runs all of them
    stop = pctx is None or pctx.local
    for g in range(cfg.n_groups()):
        if remat and torch.is_grad_enabled():
            with set_checkpoint_early_stop(stop):
                x, a = checkpoint(group, g, x, cross, use_reentrant=False)
        else:
            x, a = group(g, x, cross)
        aux = aux + a
    return x, aux


def encode(cfg: ModelConfig, params: Dict, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """The whisper encoder (``transformer.py::_encode``) on stub frame
    embeddings (B, S_enc, D): ``enc_pos`` added in the compute dtype, the
    non-causal ``("attn", "mlp")`` stack, ``enc_final_norm``.  Returns the
    encoder output (B, S_enc, D) every decoder layer projects its own
    cross K/V from."""
    ecfg = cfg.encoder()
    frames = frames.to(cfg.compute_dtype)
    x = frames + params["enc_pos"][None, :frames.shape[1]].to(frames.dtype)
    x, _ = stack_forward(ecfg, params["enc_layers"], x, remat)
    return apply_norm(ecfg, params["enc_final_norm"], x)


def patch_inject(params: Dict, x: torch.Tensor, patches: torch.Tensor
                 ) -> torch.Tensor:
    """The vision stub (``transformer.py::_patch_inject``): precomputed
    patch embeddings (B, P, D) in the compute dtype, times ``vis_proj``,
    added at the first P positions of x (B, S, D), where the pipeline's
    token id -1 left zero embeddings."""
    P = patches.shape[1]
    if P > x.shape[1]:
        raise ValueError(f"{P} patches do not fit a sequence of "
                         f"{x.shape[1]}")
    proj = patches.to(x.dtype) @ params["vis_proj"]
    return torch.cat([x[:, :P] + proj, x[:, P:]], dim=1)


def _modality(cfg: ModelConfig, batch: Dict, key: str) -> torch.Tensor:
    if key not in batch:
        raise ValueError(f"{cfg.name}: a {cfg.family} batch needs "
                         f"{key!r} beside the tokens")
    return batch[key]


def patch_inject_grid(pctx: ParallelContext, params: Dict,
                      patches: torch.Tensor, s_loc: int) -> torch.Tensor:
    """The vision stub on one PE (``repro/models/transformer.py:377-389``):
    the (B, P, D) patch embeddings padded to S_loc positions, this PE's
    natural column block, zeros off grid row 0, through ``vis_proj`` as a
    classic Cannon GEMM (``kind="std"``: natural in, natural out)."""
    B, P, _ = patches.shape
    if P > s_loc:
        raise ValueError(f"{P} patches do not fit a sequence block of "
                         f"{s_loc}")
    i, _ = pctx.grid.my_coords()
    padded = F.pad(patches, (0, 0, 0, s_loc - P))
    blocked = col_slice(pctx, padded, layout="blocked").to(
        pctx.compute_dtype)
    blocked = blocked * float(i == 0)
    return dense(pctx, blocked, params["vis_proj"], kind="std")


def _forward_grid(pctx: ParallelContext, cfg: ModelConfig, params: Dict,
                  batch: Dict, remat: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``forward`` on one PE of a blocked grid (module docstring)."""
    if cfg.enc_layers:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models on a "
                                  f"PE grid come with a later slice")
    x = embed_tokens_grid(pctx, params["embed"], batch["tokens"],
                          cfg.compute_dtype)
    if cfg.vis_patches:
        x = x + patch_inject_grid(pctx, params,
                                  _modality(cfg, batch, "patches"),
                                  x.shape[1])
    if pctx.tp_strategy == "cannon_opt":
        # enter the permanently skewed residual layout (one put)
        x = skew_activation(pctx.grid, x)
    x, aux = stack_forward(cfg, params["layers"], x, remat, pctx=pctx)
    return apply_norm(cfg, params["final_norm"], x, pctx), aux


def forward(cfg: ModelConfig, params: Dict, batch: Dict,
            remat: bool = False, pctx: Optional[ParallelContext] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens (B, S) [+ frames (B, S_enc, D) for encoder-decoder,
    patches (B, P, D) for vision-language models, whose token ids are -1
    at the patch positions].  Returns (x after the final norm (B, S, D),
    summed MoE aux loss).  With a blocked grid ``pctx``: this PE's
    blocks of both, x (B, S/q, D/r) in the residual layout (skewed under
    cannon_opt)."""
    if pctx is not None and pctx.blocked:
        return _forward_grid(pctx, cfg, params, batch, remat)
    frames = _modality(cfg, batch, "frames") if cfg.enc_layers else None
    patches = _modality(cfg, batch, "patches") if cfg.vis_patches else None
    x = embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    cross = None if frames is None else encode(cfg, params, frames, remat)
    if patches is not None:
        x = patch_inject(params, x, patches)
    x, aux = stack_forward(cfg, params["layers"], x, remat, cross)
    return apply_norm(cfg, params["final_norm"], x), aux


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict,
            remat: bool = False, pctx: Optional[ParallelContext] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Labels (B, S) already shifted, -100 masked.  Returns (mean token
    loss + aux, {ce_loss, aux, n_tokens}).  With a blocked grid ``pctx``
    every PE returns the global values: its row's loss sum, valid labels
    and aux summed over the rows in one ``psum_rows`` (the aux then
    averaged over them), as ``repro/models/transformer.py:404-420``."""
    if pctx is not None and pctx.blocked:
        x, aux = forward(cfg, params, batch, remat, pctx=pctx)
        s, n = lm_loss_grid(pctx, params["lm_head"], x, batch["labels"],
                            cfg.vocab_size)
        s, n, aux = pctx.grid.psum_rows(torch.stack([s, n, aux]))
        aux = aux / pctx.q
        loss = s / torch.clamp(n, min=1.0)
        return loss + aux, {"ce_loss": loss, "aux": aux,
                            "n_tokens": n.to(torch.int32)}
    x, aux = forward(cfg, params, batch, remat)
    s, n = lm_loss(params["lm_head"], x, batch["labels"])
    loss = s / torch.clamp(n, min=1).float()
    return loss + aux, {"ce_loss": loss, "aux": aux, "n_tokens": n}
