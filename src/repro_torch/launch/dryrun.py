"""Multi-pod dry run on the meta device, as ``repro.launch.dryrun``.

For every (architecture x input shape) cell, on the single-pod 16x16 mesh
and the 2x16x16 multi-pod mesh, the cell's call runs once on
``torch.device("meta")`` (shapes and dtypes, no storage: nothing is
allocated on any device):

* prefill + ``sample``;
* decode_step + ``sample`` over ``init_cache``;
* or one train step with AdamW, its state laid out by the ZeRO-1
  ``zero_specs``.

The mesh's ranks sit on the port's rank axes (``distributed/context.py``):
``build_model(cfg, pcfg, tp=<model>, ep=<pod x data>, pods=<pod>)``, the
batch folded over the data shards (an ``ep2d`` model's experts over
``data`` alone, in every pod), or under ``long_500k`` the one row on
every shard, the full-attention caches' sequence over the shards where
the family has them.  The record has the reference's keys:

* ``memory.args`` / ``memory.out``: exact bytes per device, counted from
  the shapes and the reference's specs (``weights.reference_specs``, the
  ZeRO-1 ``zero_specs``) and the port's cache layout: params, optimizer
  state, cache and inputs; the outputs.  ``temp``, ``alias`` and
  ``code`` are null: a meta run has no compiler's buffer assignment to
  read them from (``memory_note``);
* ``roofline``: ``analysis.roofline.analyze`` of the call's
  ``analysis.op_costs`` counts.  A train cell adds the gradient
  all-reduces the reference's transpose inserts: every gradient over the
  data axes, and a model-replicated leaf's over the model axis (the
  rank axis's autograd sums them in place).

Usage::

    cd src && python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k [--multi-pod] [--out runs/dryrun.json]
    cd src && python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch import weights
from repro_torch.analysis import op_costs
from repro_torch.analysis.roofline import analyze
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, cell_applicable, input_specs
from repro_torch.models.build import build_model
from repro_torch.runtime.sampler import sample
from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                            zero_specs)
from repro_torch.training.train_step import make_train_step

META = torch.device("meta")
MEMORY_NOTE = ("temp, alias and code need a compiler's buffer assignment; "
               "a meta run has none")
# the families whose caches split their sequence over the data axes
_SEQ_SHARDS = ("dense", "moe", "vlm", "hybrid")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _spec_bytes(t, spec, mesh) -> float:
    """One device's bytes of ``t`` (the reference's layout) under
    ``spec``."""
    div = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                div *= mesh.size(a)
    return _nbytes(t) / div


def _spec_tree_bytes(tree, specs, mesh) -> float:
    leaves = tree_flatten(tree)[0]
    spec_leaves = tree_flatten(specs, is_leaf=_is_spec)[0]
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(spec_leaves)} "
                         f"specs")
    return sum(_spec_bytes(t, s, mesh) for t, s in zip(leaves, spec_leaves))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a cell's devices sit on the port's rank axes: R model ranks,
    D data shards, ``fold`` of them folded into the call's batch,
    ``seq_shards`` context-parallel cache chunks, and the devices one
    call's counts are shared by."""
    tp: int
    dp: int
    fold: int
    seq_shards: int
    devices: int


def _layout(cfg, shape, mesh, dp_axes) -> Layout:
    tp, dp = mesh.size("model"), mesh.dp_size(dp_axes)
    if not shape.long_context:
        return Layout(tp, dp, dp, 1, tp * dp)
    if cfg.family in _SEQ_SHARDS:
        return Layout(tp, dp, 1, dp, tp * dp)
    return Layout(tp, dp, 1, 1, tp)      # the one row on every device


def _kv_bytes(k, v, pos, lay: Layout, max_len: int) -> float:
    """A slot cache (or a prefill chunk's kv): k, v (R, B, C, kv, dh),
    pos (B, C); the batch over ``fold`` shards, a full-attention cache's
    C over ``seq_shards``."""
    div = lay.fold * (lay.seq_shards if pos.shape[1] == max_len else 1)
    return ((_nbytes(k) + _nbytes(v)) / k.shape[0] + _nbytes(pos)) / div


def cache_bytes(cache, lay: Layout, max_len: int) -> float:
    """One device's bytes of a cache or a prefill's kv chunk in the
    port's layouts: slot caches as (k, v, pos) dicts or tuples, Mamba
    states (L, R or 1, B, ...) with the rank axis second (size 1:
    replicated)."""
    if isinstance(cache, dict) and set(cache) == {"k", "v", "pos"}:
        return _kv_bytes(cache["k"], cache["v"], cache["pos"], lay, max_len)
    if (isinstance(cache, tuple) and len(cache) == 3
            and all(isinstance(t, torch.Tensor) for t in cache)
            and cache[2].dtype == torch.int32 and cache[2].dim() == 2):
        return _kv_bytes(*cache, lay, max_len)
    if isinstance(cache, dict):
        return sum(cache_bytes(v, lay, max_len) for v in cache.values())
    if isinstance(cache, (list, tuple)):
        return sum(cache_bytes(v, lay, max_len) for v in cache)
    if isinstance(cache, torch.Tensor):
        return _nbytes(cache) / cache.shape[1] / lay.fold
    raise TypeError(f"unexpected cache leaf {type(cache)}")


def input_bytes(ins, lay: Layout) -> float:
    """The inputs' bytes per device: the batch over the data shards (a
    one-row batch is on every device)."""
    total = 0.0
    for t in ins.values():
        b = t.shape[0]
        total += _nbytes(t) / (lay.dp if b > 1 and b % lay.dp == 0 else 1)
    return total


def build_cell(arch: str, shape_name: str, mesh, *, multi_pod: bool,
               pcfg_overrides=None, cfg_overrides=None):
    """Returns (fn, inputs, meta): ``fn(*inputs, recorder)`` runs the cell
    on meta tensors (``recorder``: ``op_costs.counting``'s, for the
    collectives the call knows of); ``meta`` holds the reference's
    fields, the per-device byte counts (``_bytes``; a prefill's outputs
    once it has run) and the cell's ``Layout`` (``_layout``)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    skip = cell_applicable(cfg, shape)
    if skip:
        return None, None, {"skip": skip}

    dp_axes = ("pod", "data") if multi_pod else ("data",)
    n_dev = math.prod(mesh.sizes)
    over = dict(dp_axes=dp_axes, comm_mode="fused", tokenweave=True,
                seq_shard_kv=shape.long_context, attn_impl="chunked")
    over.update(pcfg_overrides or {})
    pcfg = ParallelConfig(**over)
    lay = _layout(cfg, shape, mesh, dp_axes)
    sharded = lay.fold > 1 or lay.seq_shards > 1
    api = build_model(cfg, pcfg, tp=lay.tp, ep=lay.dp if sharded else 1,
                      pods=mesh.size("pod") if sharded else 1)
    ins = input_specs(cfg, shape, mesh, dp_axes)
    params = api.init(0, device=META)
    ref_params = weights.to_jax_layout(params, cfg, pcfg)
    pspec = api.specs(params)
    param_bytes = _spec_tree_bytes(ref_params, pspec, mesh)

    meta = {"arch": arch, "shape": shape_name,
            "multi_pod": multi_pod, "n_devices": n_dev,
            "kind": shape.kind, "seq_len": shape.seq_len,
            "n_tokens": shape.global_batch * shape.seq_len
            if shape.kind != "decode" else shape.global_batch,
            "decode_context": shape.seq_len if shape.kind == "decode" else 0,
            "train": shape.kind == "train"}
    byts = {"params": param_bytes, "inputs": input_bytes(ins, lay)}
    meta["_bytes"], meta["_layout"] = byts, lay
    kw = {k: ins[k] for k in ("mrope_positions", "extra_embeds")
          if k in ins}

    if shape.kind == "train":
        dp_size = mesh.dp_size(dp_axes)
        step, _ = make_train_step(api, mesh, ins, AdamWConfig(),
                                  dp_size=dp_size)
        opt = init_opt_state(params)
        shapes = tree_map(lambda t: tuple(t.shape), ref_params)
        ospec = zero_specs(shapes, pspec, dp_axes, dp_size)
        ref_m = tree_map(lambda t: t.float(), ref_params)
        byts["opt"] = 2 * _spec_tree_bytes(ref_m, ospec, mesh) + 4
        byts["out"] = param_bytes + byts["opt"] + 2 * 4

        def fn(params, opt, batch, rec):
            out = step(params, opt, batch)
            _note_grad_syncs(rec, ref_params, pspec, mesh, dp_axes)
            return out
        return fn, (params, opt, ins), meta

    tok_bytes = 4 * shape.global_batch

    if shape.kind == "prefill":
        def fn(params, ins, rec):
            if cfg.family == "encdec":
                logits, kv = api.prefill(
                    params, ins["tokens"], None, None, frames=ins["frames"])
            else:
                logits, kv = api.prefill(
                    params, ins["tokens"], None, ins.get("positions"), **kw)
            tok = sample(logits, vocab_size=cfg.vocab_size)
            byts["out"] = tok_bytes + cache_bytes(kv, lay, shape.seq_len)
            return tok, kv
        return fn, (params, ins), meta

    rows = ins["tokens"].shape[0]
    cache = api.init_cache(rows, shape.seq_len, device=META)
    byts["cache"] = cache_bytes(cache, lay, shape.seq_len)
    byts["out"] = tok_bytes + byts["cache"]

    def fn(params, ins, cache, rec):
        logits, cache = api.decode_step(
            params, ins["tokens"], cache, ins["positions"],
            **({"mrope_positions": ins["mrope_positions"]}
               if "mrope_positions" in ins else {}))
        return sample(logits, vocab_size=cfg.vocab_size), cache
    return fn, (params, ins, cache), meta


def _note_grad_syncs(rec, ref_params, pspec, mesh, dp_axes) -> None:
    """The gradient all-reduces of the reference's train step: each
    gradient over the data axes its spec leaves free (an ``ep2d`` expert
    leaf's over ``pod`` alone), and a leaf replicated over the model axis
    over it too (one device's bytes of the gradient each)."""
    tp = mesh.size("model")
    for t, spec in zip(tree_flatten(ref_params)[0],
                       tree_flatten(pspec, is_leaf=_is_spec)[0]):
        nb = _spec_bytes(t, spec, mesh)
        axes = {a for e in spec for a in (e if isinstance(e, tuple) else (e,))}
        free = [a for a in dp_axes if a not in axes]
        if free:
            rec.note("all-reduce", nb, math.prod(map(mesh.size, free)))
        if "model" not in axes:
            rec.note("all-reduce", nb, tp)


def run_cell(arch, shape_name, *, multi_pod, out_path=None, mesh=None,
             pcfg_overrides=None, cfg_overrides=None, tag="baseline"):
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    key = f"{arch}|{shape_name}|{'2x16x16' if multi_pod else '16x16'}|{tag}"
    try:
        fn, inputs, meta = build_cell(arch, shape_name, mesh,
                                      multi_pod=multi_pod,
                                      pcfg_overrides=pcfg_overrides,
                                      cfg_overrides=cfg_overrides)
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "tag": tag,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        print(f"[dryrun] {key} BUILD FAILED: {rec['error']}")
        _emit(out_path, key, rec)
        return rec
    byts = meta.pop("_bytes", None)
    lay = meta.pop("_layout", None)
    rec = dict(meta, tag=tag, mesh=str(dict(mesh.shape)))
    if fn is None:
        rec["status"] = "skipped"
        _emit(out_path, key, rec)
        return rec
    try:
        t1 = time.time()
        with op_costs.counting(devices=lay.devices, fold=lay.fold,
                               ride=lay.tp) as (res, recorder):
            fn(*inputs, recorder)
        t2 = time.time()
        cfg = get_config(arch)
        if cfg_overrides:
            cfg = dataclasses.replace(cfg, **cfg_overrides)
        roof = analyze(res[0], cfg, n_devices=meta["n_devices"],
                       n_tokens_global=meta["n_tokens"], train=meta["train"],
                       decode_context=meta["decode_context"],
                       seq_len=meta["seq_len"])
        args = (byts["params"] + byts.get("opt", 0) + byts.get("cache", 0)
                + byts["inputs"])
        rec.update(
            status="ok", lower_s=round(t1 - t0, 1),
            compile_s=round(t2 - t1, 1),
            memory=dict(args=int(round(args)), out=int(round(byts["out"])),
                        temp=None, alias=None, code=None,
                        params=int(round(byts["params"])),
                        opt=int(round(byts.get("opt", 0))),
                        cache=int(round(byts.get("cache", 0))),
                        inputs=int(round(byts["inputs"]))),
            memory_note=MEMORY_NOTE,
            roofline=roof.to_dict())
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {key} FAILED: {rec['error']}")
    _emit(out_path, key, rec)
    return rec


def _emit(out_path, key, rec):
    if not out_path:
        return
    data = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            data = json.load(f)
    rec = dict(rec)
    rec.pop("traceback", None)
    data[key] = rec
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, default=str)
    os.replace(tmp, out_path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="runs/dryrun.json")
    p.add_argument("--skip-done", action="store_true")
    p.add_argument("--tag", default="baseline")
    args = p.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]

    done = {}
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            done = {k: v for k, v in json.load(f).items()
                    if v.get("status") in ("ok", "skipped")}

    for mp in meshes:
        mesh = make_production_mesh(multi_pod=mp)
        for arch in archs:
            for shape in shapes:
                key = (f"{arch}|{shape}|{'2x16x16' if mp else '16x16'}"
                       f"|{args.tag}")
                if key in done:
                    print(f"[dryrun] {key}: cached, skipping")
                    continue
                print(f"[dryrun] === {key} ===", flush=True)
                rec = run_cell(arch, shape, multi_pod=mp, out_path=args.out,
                               mesh=mesh, tag=args.tag)
                print(f"[dryrun] {key}: {rec['status']} "
                      f"(lower {rec.get('lower_s')}s, "
                      f"compile {rec.get('compile_s')}s)", flush=True)


if __name__ == "__main__":
    main()
