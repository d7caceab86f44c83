"""Sort/operator configuration — the analogue of the reference's tuning
policy hub (CUB ``dispatch/tuning/tuning_radix_sort.cuh:358-1063``), reduced
to what the engines here read.

A small frozen dataclass, resolved at trace time: the engine, plus the digit
width and tile size of the reference engine. Everything is static so the
whole pipeline stays jit-compilable.
"""

from __future__ import annotations

import dataclasses

ENGINES = ("auto", "xla", "reference")


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Static configuration for one sort/partition invocation.

    Attributes:
      radix_bits: reference-engine digit width in bits (CUB uses 5-8; the
        default 8 gives 256 bins).
      tile_rows: reference-engine tile height; a tile holds
        ``tile_rows * 128`` keys, one spine entry per (digit, tile).
      engine: 'auto' | 'xla' | 'reference'.
        - xla: stable ``jax.lax.sort`` over the key limbs (XLA:GPU hands
          single-key sorts to CUB's radix sort). 'auto' resolves to it.
        - reference: pure-jnp LSD pipeline (histogram, spine scan, scatter)
          — the semantics oracle; runs anywhere.
    """

    radix_bits: int = 8
    tile_rows: int = 64
    engine: str = "auto"

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(
                f"engine must be one of {ENGINES}; got {self.engine!r}")

    @property
    def num_bins(self) -> int:
        return 1 << self.radix_bits

    @property
    def tile_elems(self) -> int:
        return self.tile_rows * 128

    def replace(self, **kw) -> "SortConfig":
        return dataclasses.replace(self, **kw)


def resolve(config: SortConfig | None = None, **overrides) -> SortConfig:
    cfg = config or SortConfig()
    if overrides:
        cfg = cfg.replace(**overrides)
    if cfg.engine == "auto":
        cfg = cfg.replace(engine="xla")
    return cfg
