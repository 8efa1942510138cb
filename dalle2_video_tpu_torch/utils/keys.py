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

from typing import List, Sequence, Tuple

import numpy as np
import torch

_MASK63 = (1 << 63) - 1
_SPLIT, _FOLD = 0, 1


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
