"""Uniform model API, as ``repro.models.build``: the dense, MoE
(``expert``, ``ffn``, ``ep2d``) and vlm families of the transformer, the
ssm family (``mamba_model``), the hybrid one (``hybrid``) and the
encoder-decoder (``encdec``), at any tp (the ranks on one device's rank
axis).  The ssm, hybrid and encdec modules have no verify, packed or
paged step: the engine refuses those modes for them, as the reference's
does.

``ep`` is the size of the data rank axis D (the reference's ``ep =
mesh.shape["data"]``): ``ep2d`` experts split over it, the transformer's
batch splits over it, or, under ``pcfg.seq_shard_kv``, the transformer's
and the hybrid's full-attention caches split their sequence over it
(``models/transformer.py``).  Every bound call passes it on as ``dp``.

``prefill`` passes its keywords on: ``frames`` (encdec), and
``mrope_positions`` and ``extra_embeds`` (vlm); ``init_cache`` passes
``enc_len`` (encdec).

``train_loss`` gives the reference's (loss_sum, denom, aux) once per data
shard, as (D,) tensors: the transformer splits its batch over D itself
(a MoE layer routes per shard), the other families run each shard's rows
on their own (nothing crosses data shards in them).  ``specs`` reads
the reference's layout off a parameter tree (``weights.py``).

``groups`` (``launch.mesh.init_groups``) puts the model on the
``process_group`` backend: this process holds one model rank (params,
caches and logits with a rank axis of 1) and every family's calls pass
the groups on.  It is ported for the serving calls of every family but
``ep2d`` at data size 1, and for the dense family's context-parallel
decode over the data group; ``ep2d``, the batch over the data group, the
verify step and training refuse it by name (ROADMAP.md)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import weights
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.distributed.context import CommCtx
from repro_torch.models import encdec, hybrid, mamba_model, transformer

FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": mamba_model, "hybrid": hybrid, "encdec": encdec}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """Bound functional API over one model family."""
    cfg: ModelConfig
    pcfg: ParallelConfig
    mod: Any
    tp: int = 1
    ep: int = 1
    groups: Any = None

    @property
    def _dp(self) -> dict:
        """The data size for the modules that take one, and the groups."""
        kw = {"dp": self.ep} if self.mod in (transformer, hybrid) else {}
        if self.groups is not None:
            kw["groups"] = self.groups
        return kw

    @property
    def comm_ctx(self) -> CommCtx:
        """The CommCtx of collectives outside the model (the sampler's):
        the rank axis, or ``process_group`` over ``groups``."""
        return CommCtx(tp=self.tp, dp=self.ep, groups=self.groups,
                       backend=("rank_axis" if self.groups is None
                                else "process_group"))

    def _refuse_groups(self, what: str) -> None:
        if self.groups is not None:
            raise NotImplementedError(
                f"{what} over the process_group backend is not ported "
                f"(ROADMAP.md)")

    def init(self, seed: int = 0, *, device=None, dtype=None):
        """Random weights; with ``groups`` this process's model rank's
        slice of the tp-rank weights drawn from ``seed``."""
        kw = {"ep": self.ep} if self.mod is transformer else {}
        if self.groups is not None:
            kw["rank"] = self.groups.model_rank
        return self.mod.init_params(self.cfg, seed=seed, device=device,
                                    dtype=dtype, tp=self.tp, **kw)

    def init_cache(self, batch: int, max_len: int, *, device=None, **kw):
        kw.update(self._dp)
        if "dp" in kw:
            kw["seq_shard_kv"] = self.pcfg.seq_shard_kv
        return self.mod.init_cache(batch, max_len, self.cfg, self.tp,
                                   device=device, **kw)

    def train_loss(self, params, batch, *, dp: int | None = None):
        """batch {"tokens" (B, S), "labels" (B, S_labels), and per family
        "frames" (encdec), "mrope_positions" / "extra_embeds" (vlm)}, B
        holding ``dp`` (default ``ep``) data shards' rows one after the
        other -> (loss_sum, denom, aux), each (D,) float32."""
        self._refuse_groups("training")
        dp = self.ep if dp is None else dp
        if self.mod is transformer:
            return transformer.train_loss(params, batch, cfg=self.cfg,
                                          pcfg=self.pcfg, dp=dp)
        rows = batch["tokens"].shape[0]
        if rows % dp:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{dp} data shards")
        n = rows // dp
        outs = [self.mod.train_loss(
            params, {k: v[d * n:(d + 1) * n] for k, v in batch.items()},
            cfg=self.cfg, pcfg=self.pcfg) for d in range(dp)]
        return tuple(torch.cat(x) for x in zip(*outs))

    def specs(self, params):
        """The reference's ``api.specs()`` (tuples) for this tree."""
        return weights.reference_specs(params, self.cfg, self.pcfg)

    def forward(self, params, tokens, positions, **kw):
        """The shared forward with no cache: (hidden (R, B, S, d), chunk
        kv per layer); ``spec.ModelDraft``'s rollout step."""
        return self.mod.forward(params, tokens, cfg=self.cfg, pcfg=self.pcfg,
                                positions=positions, **self._dp, **kw)

    def prefill(self, params, tokens, cache, positions, **kw):
        return self.mod.prefill(params, tokens, cache, cfg=self.cfg,
                                pcfg=self.pcfg, positions=positions,
                                **self._dp, **kw)

    def init_paged_cache(self, num_blocks: int, block_size: int, *,
                         device=None):
        from repro_torch.runtime.paging import init_paged_cache
        return init_paged_cache(num_blocks, block_size, self.cfg, self.tp,
                                device=device,
                                ranks=self.comm_ctx.local_ranks)

    def decode_step(self, params, tokens, cache, positions, **kw):
        return self.mod.decode_step(params, tokens, cache, cfg=self.cfg,
                                    pcfg=self.pcfg, positions=positions,
                                    **self._dp, **kw)

    def verify_step(self, params, tokens, cache, positions, **kw):
        self._refuse_groups("the speculative verify step")
        return self.mod.verify_step(params, tokens, cache, cfg=self.cfg,
                                    pcfg=self.pcfg, positions=positions,
                                    **self._dp, **kw)

    def packed_step(self, params, tokens, cache, positions, **kw):
        return self.mod.packed_step(params, tokens, cache, cfg=self.cfg,
                                    pcfg=self.pcfg, positions=positions,
                                    **self._dp, **kw)


def build_model(cfg: ModelConfig, pcfg: ParallelConfig, tp: int = 1,
                ep: int = 1, groups=None) -> ModelApi:
    if cfg.family not in FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}")
    if tp < 1 or ep < 1:
        raise ValueError(f"tp and ep must be >= 1, got {tp}, {ep}")
    mod = FAMILIES[cfg.family]
    if groups is not None:
        if cfg.family == "moe" and cfg.moe_partition == "ep2d":
            raise NotImplementedError(
                "ep2d over the process_group backend is not ported: its "
                "all-to-alls need the data group (ROADMAP.md A19)")
        if ep > 1 and not pcfg.seq_shard_kv:
            raise NotImplementedError(
                "the batch over the data group is not ported (ROADMAP.md "
                "A19); the process_group backend takes context-parallel "
                "decode (seq_shard_kv) at ep > 1")
        if ep > 1 and cfg.family != "dense":
            raise NotImplementedError(
                f"context-parallel decode over the data group is ported "
                f"for the dense family, not the {cfg.family} family "
                f"(ROADMAP.md A19)")
    if ep > 1 and not (mod is transformer or (
            mod is hybrid and pcfg.seq_shard_kv)):
        raise NotImplementedError(
            f"a data axis (ep={ep}) is ported for the transformer families "
            f"and the hybrid's context-parallel decode, not for the "
            f"{cfg.family} family")
    api = ModelApi(cfg=cfg, pcfg=pcfg, mod=mod, tp=tp, ep=ep, groups=groups)
    api.comm_ctx            # holds tp and ep to the groups' sizes
    return api
