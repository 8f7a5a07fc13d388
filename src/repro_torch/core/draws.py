"""Random draws of the V-cycle, taken from a replaceable source.

PyTorch cannot reproduce ``jax.random`` streams, so every randomised step of
the port takes its uniforms from a draw source instead of drawing them
itself:

* ``match(level, rnd, m)`` -> ``[m]`` float32 uniforms: the arc-key jitter
  of matching round ``rnd`` at coarsening level ``level``
  (``coarsen_device``);
* ``refine(seed, n, dense)`` -> an iterator that yields, per refinement
  round, a ``[3, n]`` float32 block of uniforms: row 0 picks the sparse
  round's random incident arc (``_sample_candidates``), rows 1 and 2 are the
  gate and thinning draws of ``_apply_moves``. ``dense`` rounds leave row 0
  unused;
* ``cut_refine(seed, n)`` -> an iterator that yields, per round of the
  total-cut baseline's label propagation (``baselines._cut_refine``), a
  ``[2, n]`` float32 block: row 0 the gate draws, row 1 the thinning
  draws. Every call starts the stream afresh from ``seed``, as the
  reference restarts its key at every level.

:class:`TorchDraws` is the default: ``torch.Generator`` streams on the
device, one for matching seeded with the partition seed and one per
refinement trajectory or cut-refinement level seeded with its seed. A test
can pass any object with the same three methods (for instance one that
replays the reference's key chain) to make both packages see the same
numbers.
"""
from __future__ import annotations

from typing import Iterator, Protocol

import torch


class DrawSource(Protocol):
    def match(self, level: int, rnd: int, m: int): ...

    def refine(self, seed: int, n: int, dense: bool) -> Iterator: ...

    def cut_refine(self, seed: int, n: int) -> Iterator: ...


class TorchDraws:
    """Uniform draws from ``torch.Generator`` streams on ``device``."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self._match = torch.Generator(device=self.device)
        self._match.manual_seed(int(seed))

    def match(self, level: int, rnd: int, m: int) -> torch.Tensor:
        del level, rnd  # consecutive calls advance one stream
        return torch.rand(m, generator=self._match, device=self.device)

    def refine(self, seed: int, n: int, dense: bool) -> Iterator[torch.Tensor]:
        del dense
        return self._stream(seed, (3, n))

    def cut_refine(self, seed: int, n: int) -> Iterator[torch.Tensor]:
        return self._stream(seed, (2, n))

    def _stream(self, seed: int, shape) -> Iterator[torch.Tensor]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        while True:
            yield torch.rand(shape, generator=gen, device=self.device)
