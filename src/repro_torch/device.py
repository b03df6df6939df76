"""Where the port's entry points put their tensors."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA; raises when neither is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return torch.device("cuda")


def generator(device: torch.device, seed: int):
    """A seeded generator on ``device``; None on ``meta``, whose tensors
    hold no values to draw (the dry run's ``launch/dryrun.py``)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def randn_ranks(gen, shape, *, rank=None, data_rank=None, device,
                dtype) -> torch.Tensor:
    """``torch.randn(shape)`` from ``gen``, the draw of all tp ranks along
    its leading axis; with ``rank``, model rank ``rank``'s slice of it as a
    tensor of its own (the whole draw is freed at once), so that one
    process's weights equal its slice of the tp-rank draw.  With
    ``data_rank`` too the draw's two leading axes are (data, model), as an
    ``ep2d`` expert weight's, and (data_rank, rank)'s slice is kept."""
    w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if rank is None:
        return w
    if data_rank is None:
        return w[rank:rank + 1].clone()
    return w[data_rank:data_rank + 1, rank:rank + 1].clone()
