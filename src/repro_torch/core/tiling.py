"""Tile specifications (copy of the parts of ``repro/core/tiling.py`` the
port reads).

In the reference a :class:`TileSpec` picks how the matching stages are
tiled (``rows``, ``support_rows``), which formulation the dense stage uses
(``gather``) and its SAD arithmetic (``precision``).  Tiling and precision
are bitwise invisible there, and the port's kernels take whole frames or
whole waves, so the port reads ``gather`` alone, as the reference's Pallas
backends route on it:

* ``tile=None`` (every reference backend's default tile is
  ``gather="stream"``) or ``TileSpec(gather="stream")`` takes the stream
  route: grid-vector bitmasks and the gather-free scan over d;
* :data:`UNTILED`, or a ``TileSpec`` whose ``gather`` is one of
  :data:`WINDOWED_GATHERS`, takes the candidate route: per-pixel candidate
  tensors and the candidate-window kernel (one formulation serves all three
  gather names, which are bitwise equal in the reference).

``rows``, ``support_rows`` and ``precision`` are validated as in the
reference and otherwise ignored.  There is no ``TileCapability`` and no
backend registry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

#: The candidate-gather formulations of the windowed dense path.
WINDOWED_GATHERS = ("take", "onehot", "slice")

#: All dense-stage formulations a ``TileSpec`` may request.
GATHER_IMPLS = WINDOWED_GATHERS + ("stream",)

#: Dense-stage SAD arithmetic precisions (bitwise identical).
PRECISION_IMPLS = ("f32", "int8")

#: Explicit "run the untiled path" request: the candidate route.
UNTILED = "untiled"

#: What the public entry points accept for their ``tile`` argument.
TileArg = Union["TileSpec", None, str]

STREAM = "stream"
WINDOWED = "windowed"


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """How the reference tiles the matching stages; the port reads
    ``gather`` only (see the module docstring)."""

    rows: int = 16
    support_rows: Optional[int] = None
    gather: str = "take"
    precision: str = "f32"

    def __post_init__(self):
        if self.rows < 1:
            raise ValueError(f"tile rows must be >= 1, got {self.rows}")
        if self.support_rows is not None and self.support_rows < 1:
            raise ValueError(f"support tile rows must be >= 1, got {self.support_rows}")
        if self.gather not in GATHER_IMPLS:
            raise ValueError(f"gather must be one of {GATHER_IMPLS}, got {self.gather!r}")
        if self.precision not in PRECISION_IMPLS:
            raise ValueError(
                f"precision must be one of {PRECISION_IMPLS}, got {self.precision!r}"
            )


def dense_route(tile: TileArg) -> str:
    """:data:`STREAM` or :data:`WINDOWED`: the dense route a ``tile``
    argument selects (raises on anything else)."""
    if tile is None:
        return STREAM
    if isinstance(tile, TileSpec):
        return STREAM if tile.gather == "stream" else WINDOWED
    if isinstance(tile, str) and tile == UNTILED:
        return WINDOWED
    raise ValueError(f"tile must be a TileSpec, None, or {UNTILED!r}; got {tile!r}")
