"""The assigned input-shape sets and each (arch x shape) cell's inputs, as
``repro.launch.shapes``.

The reference's inputs are ``jax.ShapeDtypeStruct`` stand-ins with a
sharding; here they are tensors on ``torch.device("meta")`` (shape and
dtype, no storage), with the reference's global shapes and dtypes.  The
batch's split over the data axes is the caller's (``launch/dryrun.py``):
the port folds the data shards into the batch (``distributed/context.py``).
The four LM shapes:

    train_4k     seq 4096   global_batch 256   -> train step
    prefill_32k  seq 32768  global_batch 32    -> serve prefill
    decode_32k   seq 32768  global_batch 128   -> serve decode (1 new token)
    long_500k    seq 524288 global_batch 1     -> long-context decode

``long_500k`` runs only for archs with bounded state
(``cfg.supports_long_context``).  Family quirks: Whisper's encoder takes
the real 1500-frame mel window (its conv front end stubbed, so frames are
embeddings), and the VLM's context is a quarter patch embeddings, with
M-RoPE ids over the whole of it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    long_context: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1,
                           long_context=True),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if shape.long_context and not cfg.supports_long_context:
        return ("pure full-attention arch: 500k decode KV state unbounded "
                "(DESIGN.md §4)")
    return None


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh=None,
                dp_axes=("data",), *,
                device="meta") -> Dict[str, torch.Tensor]:
    """The model inputs of one cell as empty tensors on ``device`` (meta
    by default), with the reference's global shapes and dtypes.  ``mesh``
    and ``dp_axes`` are the reference's arguments; the shapes do not
    depend on them."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def t(shp, dtype=i32):
        return torch.empty(shp, dtype=dtype, device=device)

    if cfg.family == "encdec":
        # seq_len is the DECODER length; the encoder takes the real
        # 1500-frame window (the conv front end stubbed -> embeddings)
        s_enc = cfg.max_source_positions
        if shape.kind == "train":
            return {"frames": t((b, s_enc, cfg.d_model), torch.bfloat16),
                    "tokens": t((b, s)), "labels": t((b, s))}
        if shape.kind == "prefill":
            return {"frames": t((b, s_enc, cfg.d_model), torch.bfloat16),
                    "tokens": t((b, s))}
        return {"tokens": t((b, 1)), "positions": t((b, 1))}

    if cfg.family == "vlm" and shape.kind != "decode":
        # dynamic-resolution stub: 1/4 of the context is patch embeddings
        s_img = s // 4
        out = {"tokens": t((b, s - s_img)),
               "extra_embeds": t((b, s_img, cfg.d_model), torch.bfloat16),
               "mrope_positions": t((b, 3, s))}
        if shape.kind == "train":
            out["labels"] = t((b, s))
        return out

    out = {"tokens": t((b, s if shape.kind != "decode" else 1))}
    if shape.kind == "train":
        out["labels"] = t((b, s))
    if shape.kind == "decode":
        out["positions"] = t((b, 1))
        if cfg.family == "vlm":
            out["mrope_positions"] = t((b, 3, 1))
    if shape.kind == "prefill":
        out["positions"] = t((b, s))
    return out
