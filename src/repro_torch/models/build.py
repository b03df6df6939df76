"""Uniform model API, as ``repro.models.build``: the dense, MoE
(``expert``, ``ffn``, ``ep2d``) and vlm families of the transformer, the
ssm family (``mamba_model``), the hybrid one (``hybrid``) and the
encoder-decoder (``encdec``), at any tp (the ranks on one device's rank
axis).  The ssm, hybrid and encdec modules have no verify, packed or
paged step: the engine refuses those modes for them, as the reference's
does.

``ep`` is the size of the data rank axis D, the data-parallel shards
(pod x data, pod outer): every family's batch splits over it (each
shard's rows one after the other; ``models/transformer.py``), or, under
``pcfg.seq_shard_kv``, the transformer's and the hybrid's
full-attention caches split their sequence over it.  Every bound call
passes it on as ``dp``.  ``pods`` is the pod axis's size: ``ep2d``
experts split over the data axis alone (the reference's ``ep =
mesh.shape["data"]``), ``expert_shards`` = D / pods of them, each pod
holding every expert once, while the batch stays over all D shards.

``prefill`` passes its keywords on: ``frames`` (encdec), and
``mrope_positions`` and ``extra_embeds`` (vlm); ``init_cache`` passes
``enc_len`` (encdec).

``train_loss`` gives the reference's (loss_sum, denom, aux) once per data
shard, as (D,) tensors: every family runs the batch over D folded, as
its serving calls do (a MoE layer routes per shard).  ``specs`` reads
the reference's layout off a parameter tree (``weights.py``).

``groups`` (``launch.mesh.init_groups``) puts the model on the
``process_group`` backend: this process holds one (pod, data, model)
rank (params, caches and logits with a rank axis of 1; an ``ep2d``
layer's experts of its data rank) and every family's calls pass the
groups on.  ``ep`` is then the data-parallel group's size (pod x data)
and ``pods`` the pod group's.  Every family's serving calls take the
batch over the data group (a process's calls take its data shard's
rows; ``ep2d``'s all-to-alls go over the data group, one per pod), the
transformer families and the hybrid also decode context-parallel over
it, the transformer families verify (speculative decoding), and every
family trains (``train_loss``: a process's rows are its data-parallel
shard's)."""
from __future__ import annotations

import dataclasses
from typing import Any

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
    pods: int = 1

    def __post_init__(self):
        if self.pods < 1 or self.ep % self.pods:
            raise ValueError(f"{self.ep} data-parallel shards do not split "
                             f"over {self.pods} pods")

    @property
    def expert_shards(self) -> int:
        """The shards ``ep2d`` experts split over: the data axis alone,
        D / pods (every pod holds each expert once)."""
        return self.ep // self.pods

    @property
    def _dp(self) -> dict:
        """The data size every module takes, and the groups."""
        kw = {"dp": self.ep}
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
        weight (the same on every pod)."""
        kw = {"ep": self.expert_shards} if self.mod is transformer else {}
        if self.groups is not None:
            kw["rank"] = self.groups.model_rank
            if self.cfg.is_moe and self.cfg.moe_partition == "ep2d":
                kw["data_rank"] = self.groups.data_rank
        return self.mod.init_params(self.cfg, seed=seed, device=device,
                                    dtype=dtype, tp=self.tp, **kw)

    def init_cache(self, batch: int, max_len: int, *, device=None, **kw):
        kw.update(self._dp)
        if self.mod in (transformer, hybrid):
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
        return self.mod.train_loss(params, batch, cfg=self.cfg,
                                   pcfg=self.pcfg, groups=self.groups,
                                   dp=self.ep if dp is None else dp)

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
        return self.mod.verify_step(params, tokens, cache, cfg=self.cfg,
                                    pcfg=self.pcfg, positions=positions,
                                    **self._dp, **kw)

    def packed_step(self, params, tokens, cache, positions, **kw):
        return self.mod.packed_step(params, tokens, cache, cfg=self.cfg,
                                    pcfg=self.pcfg, positions=positions,
                                    **self._dp, **kw)


def build_model(cfg: ModelConfig, pcfg: ParallelConfig, tp: int = 1,
                ep: int = 1, groups=None, pods: int = 1) -> ModelApi:
    """The bound API at ``tp`` model ranks and ``ep`` data-parallel shards
    (pod x data), ``pods`` of them pods (the groups' pod size over
    process groups)."""
    if cfg.family not in FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}")
    if tp < 1 or ep < 1:
        raise ValueError(f"tp and ep must be >= 1, got {tp}, {ep}")
    mod = FAMILIES[cfg.family]
    if groups is not None:
        if pods not in (1, groups.pod_size):
            raise ValueError(f"pods={pods} against groups of "
                             f"{groups.pod_size} pods")
        pods = groups.pod_size
    api = ModelApi(cfg=cfg, pcfg=pcfg, mod=mod, tp=tp, ep=ep, groups=groups,
                   pods=pods)
    api.comm_ctx            # holds tp and ep to the groups' sizes
    return api
