"""Random-generator plumbing (twin of ``hcunet_tpu/core/rng.py``).

The JAX package splits PRNG keys; the port derives ``torch.Generator``s:
a stream of fresh generators from one, and named sub-generators that are
stable across runs for the same name, folded in with the JAX package's
string hash.  The numbers differ from JAX's for the same seed (another
generator), so tests feed both packages numpy draws.
"""

from __future__ import annotations

from typing import Iterator

import torch

_SEED_SPAN = 2**63 - 1


def _child(parent: torch.Generator, seed: int) -> torch.Generator:
    return torch.Generator(device=parent.device).manual_seed(seed % _SEED_SPAN)


def key_stream(generator: torch.Generator) -> Iterator[torch.Generator]:
    """Infinite stream of fresh generators, each seeded by a draw from
    ``generator``."""
    while True:
        seed = int(torch.randint(0, _SEED_SPAN, (), generator=generator, device=generator.device))
        yield _child(generator, seed)


def _fold_hash(name: str) -> int:
    """The JAX package's ``fold_in_str`` hash of a name."""
    h = 0
    for ch in name:
        h = (h * 131 + ord(ch)) % (2**31 - 1)
    return h


def fold_in_str(generator: torch.Generator, name: str) -> torch.Generator:
    """A named sub-generator of ``generator``: seeded from its initial seed
    and the name's hash, so it does not depend on how far ``generator`` has
    been drawn, and is the same in every run for the same name."""
    mixed = (generator.initial_seed() * 0x9E3779B97F4A7C15 + _fold_hash(name)) % _SEED_SPAN
    return _child(generator, mixed)
