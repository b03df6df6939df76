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
The ssm, hybrid and encdec families train at any ``ep`` (``train_loss``
splits their batch over it); their serving calls refuse ``ep`` > 1 by
name (the hybrid's under ``seq_shard_kv`` aside): their batch over D is
not ported for serving (ROADMAP.md A.1).

``prefill`` passes its keywords on: ``frames`` (encdec), and
``mrope_positions`` and ``extra_embeds`` (vlm); ``init_cache`` passes
``enc_len`` (encdec).

``train_loss`` gives the reference's (loss_sum, denom, aux) once per data
shard, as (D,) tensors: the transformer splits its batch over D itself
(a MoE layer routes per shard), the other families run each shard's rows
on their own (nothing crosses data shards in them).  ``specs`` reads
the reference's layout off a parameter tree (``weights.py``).

``groups`` (``launch.mesh.init_groups``) puts the model on the
``process_group`` backend: this process holds one (data, model) rank
(params, caches and logits with a rank axis of 1; an ``ep2d`` layer's
experts of its data shard) and every family's calls pass the groups on.
``ep`` is then the data-parallel group's size (pod x data).  It is ported for the serving
calls of every family, for the transformer families' batch over the
data group (a process's calls take its data shard's rows; ``ep2d``'s
all-to-alls go over the data group) and for the context-parallel decode
of the transformer families and the hybrid over it, and for the
transformer families' verify step (speculative decoding), and for
every family's training (``train_loss``: a process's rows are its
data-parallel shard's, ``ep`` the pod x data size)."""
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

    def init(self, seed: int = 0, *, device=None, dtype=None):
        """Random weights; with ``groups`` this process's (data, model)
        rank's slice of the weights drawn from ``seed``: its model rank's
        of every sharded leaf, and its data rank's of an ``ep2d`` expert
        weight."""
        kw = {"ep": self.ep} if self.mod is transformer else {}
        if self.groups is not None:
            kw["rank"] = self.groups.model_rank
            if self.cfg.is_moe and self.cfg.moe_partition == "ep2d":
                kw["data_rank"] = self.groups.data_rank
        return self.mod.init_params(self.cfg, seed=seed, device=device,
                                    dtype=dtype, tp=self.tp, **kw)

    def _check_serving(self) -> None:
        """Raise, naming the family, where a serving call meets a data
        axis that is ported for training alone."""
        if self.ep > 1 and not (self.mod is transformer or (
                self.mod is hybrid and self.pcfg.seq_shard_kv)):
            raise NotImplementedError(
                f"a data axis (ep={self.ep}) is ported for the "
                f"{self.cfg.family} family's training, not for its serving "
                f"calls (ROADMAP.md A.1); the transformer families serve "
                f"over it, the hybrid under seq_shard_kv")

    def init_cache(self, batch: int, max_len: int, *, device=None, **kw):
        self._check_serving()
        kw.update(self._dp)
        if "dp" in kw:
            kw["seq_shard_kv"] = self.pcfg.seq_shard_kv
        return self.mod.init_cache(batch, max_len, self.cfg, self.tp,
                                   device=device, **kw)

    def train_loss(self, params, batch, *, dp: int | None = None):
        """batch {"tokens" (B, S), "labels" (B, S_labels), and per family
        "frames" (encdec), "mrope_positions" / "extra_embeds" (vlm)}, B
        holding ``dp`` (default ``ep``) data shards' rows one after the
        other -> (loss_sum, denom, aux), each (D,) float32.  With
        ``groups`` the batch is this process's data-parallel shard's rows
        and each is (1,)."""
        dp = self.ep if dp is None else dp
        if self.groups is not None:
            kw = {"dp": dp} if self.mod is transformer else {}
            return self.mod.train_loss(params, batch, cfg=self.cfg,
                                       pcfg=self.pcfg, groups=self.groups,
                                       **kw)
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
        self._check_serving()
        return self.mod.forward(params, tokens, cfg=self.cfg, pcfg=self.pcfg,
                                positions=positions, **self._dp, **kw)

    def prefill(self, params, tokens, cache, positions, **kw):
        self._check_serving()
        return self.mod.prefill(params, tokens, cache, cfg=self.cfg,
                                pcfg=self.pcfg, positions=positions,
                                **self._dp, **kw)

    def init_paged_cache(self, num_blocks: int, block_size: int, *,
                         device=None):
        from repro_torch.runtime.paging import init_paged_cache
        self._check_serving()
        return init_paged_cache(num_blocks, block_size, self.cfg, self.tp,
                                device=device,
                                ranks=self.comm_ctx.local_ranks)

    def decode_step(self, params, tokens, cache, positions, **kw):
        self._check_serving()
        return self.mod.decode_step(params, tokens, cache, cfg=self.cfg,
                                    pcfg=self.pcfg, positions=positions,
                                    **self._dp, **kw)

    def verify_step(self, params, tokens, cache, positions, **kw):
        self._check_serving()
        return self.mod.verify_step(params, tokens, cache, cfg=self.cfg,
                                    pcfg=self.pcfg, positions=positions,
                                    **self._dp, **kw)

    def packed_step(self, params, tokens, cache, positions, **kw):
        self._check_serving()
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
    if (groups is not None and groups.pod_size > 1 and cfg.is_moe
            and cfg.moe_partition == "ep2d"):
        raise NotImplementedError(
            "ep2d experts split over the data axis alone; a pod axis over "
            "them is not ported (ROADMAP.md A.1)")
    api = ModelApi(cfg=cfg, pcfg=pcfg, mod=mod, tp=tp, ep=ep, groups=groups)
    api.comm_ctx            # holds tp and ep to the groups' sizes
    return api
