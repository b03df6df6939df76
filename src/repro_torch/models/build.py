"""Uniform model API, as ``repro.models.build``; the dense and MoE
(``expert``, ``ffn``) families of the transformer, at any tp (the ranks on
one device's rank axis)."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.layers.moe import EP2D_REFUSAL
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """Bound functional API over one model family."""
    cfg: ModelConfig
    pcfg: ParallelConfig
    mod: Any
    tp: int = 1

    def init(self, seed: int = 0, *, device=None, dtype=None):
        return self.mod.init_params(self.cfg, seed=seed, device=device,
                                    dtype=dtype, tp=self.tp)

    def init_cache(self, batch: int, max_len: int, *, device=None):
        return self.mod.init_cache(batch, max_len, self.cfg, self.tp,
                                   device=device)

    def forward(self, params, tokens, positions, **kw):
        """The shared forward with no cache: (hidden (R, B, S, d), chunk
        kv per layer); ``spec.ModelDraft``'s rollout step."""
        return self.mod.forward(params, tokens, cfg=self.cfg, pcfg=self.pcfg,
                                positions=positions, **kw)

    def prefill(self, params, tokens, cache, positions, **kw):
        return self.mod.prefill(params, tokens, cache, cfg=self.cfg,
                                pcfg=self.pcfg, positions=positions, **kw)

    def init_paged_cache(self, num_blocks: int, block_size: int, *,
                         device=None):
        from repro_torch.runtime.paging import init_paged_cache
        return init_paged_cache(num_blocks, block_size, self.cfg, self.tp,
                                device=device)

    def decode_step(self, params, tokens, cache, positions, **kw):
        return self.mod.decode_step(params, tokens, cache, cfg=self.cfg,
                                    pcfg=self.pcfg, positions=positions,
                                    **kw)

    def verify_step(self, params, tokens, cache, positions, **kw):
        return self.mod.verify_step(params, tokens, cache, cfg=self.cfg,
                                    pcfg=self.pcfg, positions=positions,
                                    **kw)

    def packed_step(self, params, tokens, cache, positions, **kw):
        return self.mod.packed_step(params, tokens, cache, cfg=self.cfg,
                                    pcfg=self.pcfg, positions=positions,
                                    **kw)


def build_model(cfg: ModelConfig, pcfg: ParallelConfig, tp: int = 1,
                ep: int = 1) -> ModelApi:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md A10)")
    if ep > 1 or (cfg.is_moe and cfg.moe_partition == "ep2d"):
        raise NotImplementedError(EP2D_REFUSAL)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    return ModelApi(cfg=cfg, pcfg=pcfg, mod=transformer, tp=tp)
