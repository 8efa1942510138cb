"""Chunked application (port of dalle2_video_tpu/utils/chunked.py): apply a
function over a large batch in fixed-size chunks to bound peak memory.
``VideoDecoder.sample(max_batch_size=...)`` chunks with ``split_batch``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import torch


def split_batch(batch_size: int, max_chunk: int) -> Iterator[Tuple[int, int]]:
    """Yield (start, size) spans covering [0, batch_size)."""
    start = 0
    while start < batch_size:
        size = min(max_chunk, batch_size - start)
        yield start, size
        start += size


def _map(fn: Callable, *outs: Any) -> Any:
    """``fn`` over the tensors at the same places of ``outs`` (tensors, or
    tuples, lists and dicts of them)."""
    if isinstance(outs[0], (tuple, list)):
        return type(outs[0])(_map(fn, *parts) for parts in zip(*outs))
    if isinstance(outs[0], dict):
        return {k: _map(fn, *(o[k] for o in outs)) for k in outs[0]}
    return fn(*outs)


def chunked_apply(fn: Callable[..., Any], batch_size: int, max_chunk: int, *args, **kwargs):
    """Apply ``fn`` over leading-axis chunks of every tensor argument of at
    least one dimension and concatenate the results (tensors, or tuples,
    lists and dicts of them). Eager PyTorch compiles no shape, so the last
    chunk is not padded (the JAX version's ``pad_tail``)."""
    is_arr = lambda a: torch.is_tensor(a) and a.ndim >= 1

    outs = []
    for start, size in split_batch(batch_size, max_chunk):
        take = lambda a: a[start:start + size] if is_arr(a) else a
        outs.append(fn(*(take(a) for a in args), **{k: take(v) for k, v in kwargs.items()}))
    if len(outs) == 1:
        return outs[0]
    return _map(lambda *parts: torch.cat(parts, dim=0), *outs)
