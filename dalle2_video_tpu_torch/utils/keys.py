"""Per-row random streams for reproducible serving (port of
dalle2_video_tpu/utils/keys.py).

A ``RowKeys`` holds one 63-bit seed per batch row. Every draw is made row by
row from a ``torch.Generator`` seeded with that row's seed, so row i's noise
is a pure function of its own seed: the same (prompt, seed) gives the same
video whichever micro-batch it rode in, however the batch was padded or
chunked. ``split`` and ``fold_in`` derive child seeds with numpy's
``SeedSequence`` (a hash, independent per path), the counterpart of
``jax.random.split`` / ``fold_in``. The numbers differ from JAX's threefry
streams; tests that compare with the JAX package inject the JAX draws.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from dalle2_video_tpu_torch.parallel.mesh import get_active_mesh

_MASK63 = (1 << 63) - 1
_SPLIT, _FOLD = 0, 1


def batch_draw(draw: Callable[[Tuple[int, ...]], torch.Tensor],
               shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` of a batch-major shape (a generator's draw for a
    batch's rows). Under an active mesh whose data axis splits the batch
    (``parallel.mesh.active_mesh``), the draw is made at the global batch
    (shape[0] times the data axis) and this rank's rows are returned, as
    the JAX package's sharded step draws for the global batch and shards
    it: every rank's generator stays in step, and ``data`` ranks take the
    update one device takes at the same global batch."""
    shape = tuple(shape)
    mesh = get_active_mesh()
    if mesh is None or mesh.data == 1:
        return draw(shape)
    b = shape[0]
    return draw((b * mesh.data,) + shape[1:])[mesh.data_index * b:(mesh.data_index + 1) * b]


def derive_generator(seed: int, *path: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and a path of
    integers: distinct paths give independent streams."""
    g = torch.Generator(device=device)
    g.manual_seed(_derive(seed, *path))
    return g


@contextlib.contextmanager
def init_from(generator: torch.Generator) -> Iterator[None]:
    """Modules built inside the block draw their initial weights from the
    CPU ``generator`` (torch's initialisers use the default CPU generator):
    the default generator's state is saved, set to the generator's, and
    restored after; the generator is advanced past what the block drew."""
    with torch.random.fork_rng(devices=[]):
        torch.random.set_rng_state(generator.get_state())
        yield
        generator.set_state(torch.random.get_rng_state())


def _derive(seed: int, *path: int) -> int:
    words = np.random.SeedSequence([int(seed), *map(int, path)]).generate_state(
        2, np.uint32
    )
    return ((int(words[0]) << 32) | int(words[1])) & _MASK63


class RowKeys:
    def __init__(self, seeds: Sequence[int]):
        self.seeds: Tuple[int, ...] = tuple(int(s) & _MASK63 for s in seeds)

    @classmethod
    def from_request_seeds(cls, seeds: Sequence[int]) -> "RowKeys":
        """Request seeds -> root keys (hashed, so nearby seeds decorrelate)."""
        return cls([_derive(int(s), 2) for s in seeds])

    def __len__(self) -> int:
        return len(self.seeds)

    def __repr__(self) -> str:
        return f"RowKeys({list(self.seeds)})"

    def split(self, num: int = 2) -> List["RowKeys"]:
        return [RowKeys([_derive(s, _SPLIT, i) for s in self.seeds])
                for i in range(num)]

    def fold_in(self, data: int) -> "RowKeys":
        return RowKeys([_derive(s, _FOLD, data) for s in self.seeds])

    def take(self, start: int, size: int) -> "RowKeys":
        return RowKeys(self.seeds[start:start + size])

    def repeat_interleave(self, n: int) -> "RowKeys":
        """Candidate j of row i gets fold_in(key_i, j) (best-of-N prior)."""
        return RowKeys([_derive(s, _FOLD, j) for s in self.seeds for j in range(n)])

    def normal(self, shape: Sequence[int], device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(b, ...) standard normal; row i drawn from its own generator."""
        shape = tuple(shape)
        if shape[0] != len(self.seeds):
            raise ValueError(
                f"{len(self.seeds)} row keys for a batch of {shape[0]}"
            )
        rows = []
        for s in self.seeds:
            g = torch.Generator(device=device)
            g.manual_seed(s)
            rows.append(torch.randn(shape[1:], generator=g, device=device,
                                    dtype=torch.float32))
        return torch.stack(rows).to(dtype)
