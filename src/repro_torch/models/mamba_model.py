"""Falcon-Mamba: an attention-free Mamba-1 stack with the TokenWeave weave,
as ``repro.models.mamba_model``.

TokenWeave carries over in its own way: every block is token-level except
the recurrence, whose split dependency is the prefix split's final (conv,
ssm) state -- the suffix split starts its scan there, as a transformer's
suffix attends the prefix's KV.  Each block ends in a row-parallel
``out_proj``, so the fused AllReduce-RMSNorm slot (K2 at tp=1, K1 at tp>1)
follows it once per layer, through the transformer's ``_Weave`` (its comm
stream at tp>1 on CUDA).

Parameters: {"embedding", "norm_first" (d,), "layers": [{"mamba": Mamba-1
weights (``layers/ssm.py``), "norm_out" (d,)}]}; ``norm_out`` of layer i is
layer i+1's input norm, the last one the final norm.  The state cache is
``layers.ssm.init_mamba1_state``'s, stacked over layers with the batch on
dim 2: (conv (L, R, B, K-1, dil), h (L, R, B, dil, state)); it serves as
the decode state and as the chunked-prefill carry, and ``forward`` writes
the new state into it in place.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.splitting import pad_to_multiple
from repro_torch.device import generator, randn_ranks, resolve_device
from repro_torch.distributed.context import Groups
from repro_torch.layers import embedding as E
from repro_torch.layers import ssm as S
from repro_torch.models import transformer as TR


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None, dtype=None,
                tp: int = 1, rank: Optional[int] = None):
    """Random weights for ``tp`` ranks from a seeded ``torch.Generator``
    on ``device`` (CUDA unless given), with the reference's scales and
    shapes; tests move the reference's weights over with
    ``weights.from_jax_params`` instead.  With ``rank``, model rank
    ``rank``'s weights alone (``weights.take_rank`` of the tp-rank draw),
    each leaf drawn whole and cut at once."""
    dtype = dtype or getattr(torch, cfg.dtype)
    device = resolve_device(device)
    gen = generator(device, seed)
    layers = [{"mamba": S.init_mamba1_params(gen, cfg, tp, device=device,
                                             dtype=dtype, rank=rank),
               "norm_out": torch.ones(cfg.d_model, dtype=dtype,
                                      device=device)}
              for _ in range(cfg.num_layers)]
    return {"embedding": embedding_params(gen, cfg, tp, device=device,
                                          dtype=dtype, rank=rank),
            "norm_first": torch.ones(cfg.d_model, dtype=dtype, device=device),
            "layers": layers}


def embedding_params(gen, cfg: ModelConfig, tp: int, *, device, dtype,
                     rank: Optional[int] = None):
    """The vocab-sharded embedding and LM head (scales 0.02 and d^-0.5);
    model rank ``rank``'s shard alone when given."""
    v_loc = pad_to_multiple(cfg.vocab_size, tp) // tp
    d = cfg.d_model

    def rnd(shape, scale):
        return (randn_ranks(gen, (tp,) + shape, rank=rank, device=device,
                            dtype=torch.float32) * scale).to(dtype)
    emb = {"embed": rnd((v_loc, d), 0.02)}
    if not cfg.tie_embeddings:
        emb["lm_head"] = rnd((d, v_loc), d ** -0.5)
    return emb


# --------------------------------------------------------------------------
# the weave: one recurrent layer over one or two splits
# --------------------------------------------------------------------------

def layer_state(cache, i: int):
    """Layer i of a stacked state cache (nested tuples), as views."""
    if isinstance(cache, tuple):
        return tuple(layer_state(c, i) for c in cache)
    return cache[i]


def write_layer_state(cache, i: int, state) -> None:
    """Copy one layer's state into layer i of the stacked cache."""
    if isinstance(cache, tuple):
        for c, st in zip(cache, state):
            write_layer_state(c, i, st)
    else:
        cache[i].copy_(state)


def map_state(fn, state):
    """``fn`` over every leaf of a state (nested tuples of tensors)."""
    if isinstance(state, tuple):
        return tuple(map_state(fn, t) for t in state)
    return fn(state)


def mamba_weave(block, lp, hs, ress, st, *, weave, decode: bool,
                split_rows, chunk: int):
    """One recurrent layer over every split, as the reference's weave
    (``mamba_model.forward``'s body, ``hybrid._mamba_weave``): ``block``
    is ``layers.ssm.mamba1_forward`` or ``mamba2_forward``, ``st`` the
    layer's state rows.  Prefill: split 0 starts from ``st``, the suffix
    split resumes from split 0's final state, and the layer's new state is
    the last split's.  Decode: the batch splits, each split's state rows
    are taken from ``st`` (``split_rows``: per split the index tensor of
    ``transformer.shard_split_rows``, or None where the splits' rows are
    contiguous) and the new states put back in batch order.  Each split's
    output goes through its AllReduce-norm slot.  Returns (hs, ress,
    state)."""
    n = len(hs)
    sts = [st] * n
    if decode and n == 2 and split_rows[0] is not None:
        sts = [map_state(lambda t, i=idx: t.index_select(1, i), st)
               for idx in split_rows]
    elif decode and n == 2:
        b0 = hs[0].shape[1]
        sts = [S._split_rows(st, 0, b0),
               S._split_rows(st, b0, b0 + hs[1].shape[1])]
    out_states, prev_final = [], None
    for i in range(n):
        weave.wait(i)
        init_state = prev_final if (not decode and i > 0) else sts[i]
        partial, state_i = block(lp["mamba"], hs[i], init_state=init_state,
                                 chunk=chunk, ctx=weave.ctx)
        hs[i], ress[i] = weave.comm_norm(i, partial, ress[i], lp["norm_out"])
        prev_final = state_i
        out_states.append(state_i)
    if n == 2 and decode:
        return hs, ress, map_state(
            lambda t: TR.rows_in_batch_order(t, split_rows),
            S._cat_rows(out_states))
    return hs, ress, out_states[-1]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _train_layer(block, lp, hs, ress, *, weave, chunk: int):
    hs, ress, _ = mamba_weave(block, lp, list(hs), list(ress), None,
                              weave=weave, decode=False, split_rows=None,
                              chunk=chunk)
    return hs, ress


def train_layer(block, pcfg: ParallelConfig):
    """One recurrent layer of a training forward, ``(lp, hs, ress, *,
    weave, chunk) -> (hs, ress)``, from a zero state and keeping none,
    under ``remat`` when ``pcfg.remat`` (the reference checkpoints each
    layer of its scan)."""
    return TR.remat(functools.partial(_train_layer, block), pcfg.remat)


def forward(params, tokens, *, cfg: ModelConfig, pcfg: ParallelConfig,
            positions=None, cache=None, decode: bool = False,
            ssm_chunk: int = 256, train: bool = False, dp: int = 1,
            groups: Optional[Groups] = None):
    """Returns (hidden (R, B, S, d), the same on every rank, the state
    cache).  ``cache``: the state rows of this batch, read as the start
    state (decode, or a chunk after the first) and updated in place; with
    none, the recurrence starts from zero and a fresh cache is returned.
    ``positions`` are not read: a recurrence has no positions (padding
    would enter the state, so chunks must be exact).  ``train``: no cache
    and none returned, the layers under ``remat`` (``train_layer``).
    ``dp``: the batch holds ``dp`` data shards' rows one after the other
    (``transformer.data_layout``'s batch over D; the reference's cache
    batch over ``dp_axes``): the weave decision, the comm mode's
    fallback and the slots' token ownership follow each shard's rows, and
    a decode batch split takes the same rows of every shard.
    ``groups``: this process holds one model rank of the model group (R
    = 1) and one data-parallel shard's rows."""
    tp = TR._model_ranks(params, groups)
    b, s = tokens.shape
    b_loc, dsplit = (b, 1) if groups is not None else TR.batch_layout(b, dp)
    ctx = TR._comm_ctx(pcfg, cfg, b_loc * s, tp, groups=groups,
                       dp=dsplit if groups is None else group_dp(groups))
    emb = E.embed_tokens(params["embedding"], tokens, scale=cfg.embed_scale,
                         ctx=ctx)
    split = TR._decide_split(b_loc, s, tp=tp, pcfg=pcfg, decode=decode)
    rows = (TR.shard_split_rows(split, b_loc, dsplit, emb.device) if decode
            else [None])
    if rows[0] is not None:
        embs = [emb[:, idx] for idx in rows]
    else:
        embs = [emb[:, lo:hi] if decode else emb[:, :, lo:hi]
                for lo, hi in TR._split_cuts(split, b if decode else s)]
    weave = TR._Weave(len(embs), ctx, emb.device, overlap=not train)
    hs, ress = map(list, zip(*(TR._entry_norm(weave, i, e,
                                              params["norm_first"])
                               for i, e in enumerate(embs))))
    if train:
        layer = train_layer(functools.partial(S.mamba1_forward, cfg=cfg),
                            pcfg)
        for lp in params["layers"]:
            hs, ress = layer(lp, hs, ress, weave=weave, chunk=ssm_chunk)
        return torch.cat(hs, dim=2) if len(hs) == 2 else hs[0], None
    if cache is None:
        cache = S.init_mamba1_state(b, cfg, tp, cfg.num_layers,
                                    device=emb.device, dtype=emb.dtype,
                                    ranks=ctx.local_ranks)
    for i, lp in enumerate(params["layers"]):
        hs, ress, st = mamba_weave(
            lambda p, x, **kw: S.mamba1_forward(p, x, cfg=cfg, **kw), lp,
            hs, ress, layer_state(cache, i), weave=weave, decode=decode,
            split_rows=rows, chunk=1 if decode else ssm_chunk)
        write_layer_state(cache, i, st)
    for i in range(len(hs)):
        weave.wait(i)
    h_out = torch.cat(hs, dim=1 if decode else 2) if len(hs) == 2 else hs[0]
    return TR.rows_in_batch_order(h_out, rows), cache


def lm_logits_at(params, h, last_idx=None):
    """Local logits (R, B, 1, V_loc) at each row's last token, or at its
    ``last_idx``."""
    if last_idx is None:
        h_last = h[:, :, -1:]
    else:
        r, _, _, d = h.shape
        idx = last_idx.to(h.device).long()[None, :, None, None].expand(
            r, -1, 1, d)
        h_last = torch.gather(h, 2, idx)
    return E.lm_head_logits(params["embedding"], h_last)


def group_dp(groups: Optional[Groups]) -> int:
    """The data size a family without a data axis of its own gives its
    CommCtx: the data-parallel group's under ``groups`` (a process holds
    one shard's rows), 1 on the rank axis."""
    return 1 if groups is None else groups.dp_size


def xent(params, h, labels, cfg: ModelConfig, pcfg: ParallelConfig = None,
         groups: Optional[Groups] = None, dp: int = 1):
    """(loss_sum, denom), each (D,), of the hidden rows h against
    ``labels``: one entry per data shard of the ``dp`` whose rows the
    batch holds one after the other (with ``groups``, this process's one
    shard).  With ``groups`` the sums run over the model group (the loss
    is then the same on every model rank)."""
    ctx = None
    if groups is not None:
        ctx = TR._comm_ctx(pcfg, cfg, 0, groups.model_size,
                           dp=groups.dp_size, groups=groups)
    labels = labels.to(h.device)
    b_loc, dsplit = ((labels.shape[0], 1) if groups is not None
                     else TR.batch_layout(labels.shape[0], dp))
    ls, dn = zip(*(E.sharded_softmax_xent(
        E.lm_head_logits(params["embedding"],
                         h[:, d * b_loc:(d + 1) * b_loc]),
        labels[d * b_loc:(d + 1) * b_loc], vocab_size=cfg.vocab_size,
        ctx=ctx) for d in range(dsplit)))
    return torch.stack(ls), torch.stack(dn)


def train_loss(params, batch, *, cfg: ModelConfig, pcfg: ParallelConfig,
               aux_weight: float = 0.0, dp: int = 1,
               groups: Optional[Groups] = None):
    """batch {"tokens" (B, S), "labels" (B, S)} -> (loss_sum, denom,
    aux), each (D,) float32, one entry per data shard of the ``dp`` the
    batch splits over; a recurrence has no aux loss.  With ``groups`` the
    batch is this process's data-parallel shard's rows and each is
    (1,)."""
    h, _ = forward(params, batch["tokens"], cfg=cfg, pcfg=pcfg, train=True,
                   dp=dp, groups=groups)
    ls, dn = xent(params, h, batch["labels"], cfg, pcfg, groups, dp)
    return ls, dn, torch.zeros_like(ls)


def prefill(params, tokens, cache, *, cfg, pcfg, positions=None,
            last_idx=None, dp: int = 1, groups: Optional[Groups] = None):
    """One (chunked) prefill step.  Returns (local logits at each row's
    last token, or at ``last_idx`` (R, B, 1, V_loc), the state cache)."""
    h, states = forward(params, tokens, cfg=cfg, pcfg=pcfg, cache=cache,
                        dp=dp, groups=groups)
    return lm_logits_at(params, h, last_idx), states


def decode_step(params, tokens, cache, *, cfg, pcfg, positions=None,
                dp: int = 1, groups: Optional[Groups] = None):
    """One token per row.  Returns (local logits (R, B, 1, V_loc), the
    state cache, updated in place)."""
    h, states = forward(params, tokens, cfg=cfg, pcfg=pcfg, cache=cache,
                        decode=True, dp=dp, groups=groups)
    return E.lm_head_logits(params["embedding"], h), states


def init_cache(batch: int, max_len: int, cfg: ModelConfig, tp: int = 1, *,
               device=None, dtype=None, dp: int = 1,
               groups: Optional[Groups] = None):
    """Zero state for ``batch`` rows on ``device`` (CUDA unless given), in
    the global layout the reference shards over its data axes: ``batch``
    rows over ``dp`` data shards; ``max_len`` is not needed by a
    recurrence.  With ``groups``, this process's: its model rank's state
    (R = 1) of its data shard's ``batch`` / ``dp`` rows."""
    rows, _ = TR.batch_layout(batch, dp)
    return S.init_mamba1_state(batch if groups is None else rows, cfg, tp,
                               cfg.num_layers,
                               device=resolve_device(device), dtype=dtype,
                               ranks=None if groups is None else 1)
