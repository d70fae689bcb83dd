"""Token axes padded up to a CUDA kernel's tile inside its wrapper.

The JAX package sends a token count off a Pallas kernel's tile to XLA
(its gates); the port's wrappers take every count on the kernel instead.
Each side of a token axis is padded at its end up to a multiple of the
tile, and the kernel runs on the padded layout:
- a padded key gets the bias :data:`PAD_BIAS`, far below the -1e9 of a
  masked key (``ops/attention.py:mask_to_bias``), so its softmax weight is
  0 even in a side whose keys are all masked, and a padded query, whose
  bias marks it invalid, adds nothing to AdaGML's statistics;
- padded query rows are computed and sliced off;
- the MLP's and the projections' rows are independent, so their padded
  rows are sliced off too.
Where every side is already on the tile, nothing is copied.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

PAD_BIAS = -1e30


def round_up(n: int, tile: int) -> int:
    return -(-n // tile) * tile


@functools.lru_cache(maxsize=None)
def real_index(sides: Tuple[int, ...], tile: int, device: torch.device) -> torch.Tensor:
    """Positions of the real tokens in the padded layout of ``sides``."""
    parts, start = [], 0
    for s in sides:
        parts.append(torch.arange(start, start + s))
        start += round_up(s, tile)
    return torch.cat(parts).to(device)


def scatter_tokens(t: torch.Tensor, index: torch.Tensor, total: int, fill: float = 0.0) -> torch.Tensor:
    """``t [B, N, ...]`` placed at ``index`` of a new ``[B, total, ...]``
    filled with ``fill``."""
    out = t.new_full((t.shape[0], total, *t.shape[2:]), fill)
    out[:, index] = t
    return out


def pad_sides(tensors: Sequence[Optional[torch.Tensor]], key_bias: torch.Tensor, sides: Sequence[int], tile: int):
    """``(padded tensors, padded key_bias, padded sides, index)`` of token
    tensors ``[B, N, ...]`` (None stays None) laid out as ``sides``; index
    None where every side is a multiple of ``tile`` (nothing copied)."""
    if all(s % tile == 0 for s in sides):
        return list(tensors), key_bias, list(sides), None
    index = real_index(tuple(sides), tile, key_bias.device)
    padded = [round_up(s, tile) for s in sides]
    total = sum(padded)
    out = [None if t is None else scatter_tokens(t, index, total) for t in tensors]
    return out, scatter_tokens(key_bias, index, total, PAD_BIAS), padded, index


def pad_end(t: Optional[torch.Tensor], total: int, fill: float = 0.0) -> Optional[torch.Tensor]:
    """``t [B, N, ...]`` with ``fill`` tokens appended up to ``total``."""
    if t is None or t.shape[1] == total:
        return t
    out = t.new_full((t.shape[0], total, *t.shape[2:]), fill)
    out[:, : t.shape[1]] = t
    return out


def unpad(t: torch.Tensor, index: Optional[torch.Tensor]) -> torch.Tensor:
    """The real tokens of ``t [B, N_padded, ...]``."""
    return t if index is None else t.index_select(1, index)


def pad_rows(t: Optional[torch.Tensor], rows: int, fill: float = 0.0) -> Optional[torch.Tensor]:
    """``t [R, ...]`` with rows of ``fill`` appended up to ``rows``."""
    if t is None or t.shape[0] == rows:
        return t
    out = t.new_full((rows, *t.shape[1:]), fill)
    out[: t.shape[0]] = t
    return out


def on_row_tile(fn, tile: int, x: torch.Tensor, *token_args: Optional[torch.Tensor], row_outputs: Optional[int] = None):
    """``fn(x2, *args2)`` on the tokens of ``x [..., d]`` (and of each
    ``[..., k]`` tensor in ``token_args``, the same leading shape) flattened
    to rows and padded with zero rows to a multiple of ``tile``; each output
    ``[rows, k]`` is cut back to ``x``'s leading shape. ``fn`` returns a
    tensor or a tuple of them; with ``row_outputs``, only the tuple's first
    ``row_outputs`` are rows, and the rest come back as they are."""
    lead = x.shape[:-1]
    rows = x.numel() // x.shape[-1]
    total = round_up(rows, tile)
    flat = [pad_rows(t.reshape(rows, t.shape[-1]), total) if t is not None else None for t in (x, *token_args)]
    out = fn(*flat)

    def back(y):
        return y[:rows].reshape(*lead, y.shape[-1])

    if not isinstance(out, tuple):
        return back(out)
    n = len(out) if row_outputs is None else row_outputs
    return tuple(back(y) if i < n else y for i, y in enumerate(out))
