"""Tile decompositions (counterpart of heat_tpu/core/tiling.py).

``SplitTiles`` is the grid obtained by chunking every dimension over the
ranks (the split dimension by the array's own layout), ``SquareDiagTiles``
the grid with square tiles on the diagonal that tile-wise QR and Cholesky
use.  Both are metadata: the tile grid, each tile's owning rank and its
global bounds.  A tile is read on the rank that owns it (its part of the
tile on each rank it spans) and written by each rank into its own rows,
with no communication.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .dndarray import DNDarray, _owned

__all__ = ["SplitTiles", "SquareDiagTiles"]


def _even_chunks(size: int, parts: int) -> np.ndarray:
    """Remainder-spread chunk sizes, used to carve tile rows *within* one
    rank's block."""
    chunk, rem = divmod(size, parts)
    out = np.full(parts, chunk, dtype=np.int64)
    out[:rem] += 1
    return out


def _local_part(arr: DNDarray, slices: Tuple[slice, ...]) -> Optional[torch.Tensor]:
    """This rank's part of the global block ``slices`` of ``arr`` (a copy),
    or None where it holds none of its rows."""
    if arr.split is None:
        return arr.larray[slices].clone()
    s = arr.split
    lo, hi = _owned(arr.comm, arr.gshape, s, arr.comm.rank)
    a, b = max(slices[s].start, lo), min(slices[s].stop, hi)
    if b <= a:
        return None
    local = list(slices)
    local[s] = slice(a - lo, b - lo)
    return arr.larray[tuple(local)].clone()


class SplitTiles:
    """Tiles of a DNDarray: the chunk grid obtained by chunking *every*
    dimension over ``comm.size``.

    The split dimension uses the array's actual local shapes; every other
    dimension uses the theoretical remainder-spread chunking.
    """

    def __init__(self, arr: DNDarray) -> None:
        self.__arr = arr
        lshape_map = arr.lshape_map
        ndim, size = arr.ndim, arr.comm.size
        # one chunk policy for every dimension — the canonical (padded)
        # distribution the comm layer actually uses — so the grid is
        # identical however the array is currently split.  The split axis
        # follows the REPORTED layout (ragged-aware), keeping the tile grid
        # consistent with lshape_map/__partitioned__ after redistribute_.
        tile_dims = np.zeros((ndim, size), dtype=np.int64)
        for ax in range(ndim):
            if ax == arr.split:
                tile_dims[ax] = lshape_map[:, ax]
            else:
                tile_dims[ax] = arr.comm.lshape_map(arr.gshape, ax)[:, ax]
        self.__tile_dims = tile_dims
        self.__tile_ends_g = np.cumsum(tile_dims, axis=1).astype(np.int64)
        self.__tile_locations = self.set_tile_locations(arr.split, tile_dims, arr)
        self.__lshape_map = lshape_map

    @staticmethod
    def set_tile_locations(split: Optional[int], tile_dims: np.ndarray, arr: DNDarray) -> np.ndarray:
        """Grid (size ^ ndim) of owning rank per tile."""
        grid_shape = [tile_dims[d].size for d in range(arr.ndim)]
        locations = np.zeros(grid_shape, dtype=np.int64)
        if split is None:
            locations += arr.comm.rank
            return locations
        sl = [slice(None)] * arr.ndim
        for pr in range(1, arr.comm.size):
            sl[split] = pr
            locations[tuple(sl)] = pr
        return locations

    @property
    def arr(self) -> DNDarray:
        """The tiled DNDarray."""
        return self.__arr

    @property
    def lshape_map(self) -> np.ndarray:
        """(size, ndim) local shapes."""
        return self.__lshape_map

    @property
    def tile_locations(self) -> np.ndarray:
        """Owning rank of each tile."""
        return self.__tile_locations

    @property
    def tile_ends_g(self) -> np.ndarray:
        """Global end index of each tile per dimension."""
        return self.__tile_ends_g

    @property
    def tile_dimensions(self) -> np.ndarray:
        """Tile extents per dimension."""
        return self.__tile_dims

    def __tile_slices(self, key) -> Tuple[slice, ...]:
        """Convert tile-grid indices to global index slices."""
        arr = self.__arr
        if isinstance(key, (int, np.integer, slice)):
            key = (key,)
        key = tuple(key) + (slice(None),) * (arr.ndim - len(key))
        out = []
        for d, k in enumerate(key):
            ends = self.__tile_ends_g[d]
            if isinstance(k, (int, np.integer)):
                if k < 0:
                    k += ends.size
                start = int(ends[k - 1]) if k > 0 else 0
                stop = int(ends[k])
            elif isinstance(k, slice):
                idx = np.arange(ends.size)[k]
                if idx.size == 0:
                    start = stop = 0
                else:
                    start = int(ends[idx[0] - 1]) if idx[0] > 0 else 0
                    stop = int(ends[idx[-1]])
            else:
                raise TypeError(f"key type not supported: {type(k)}")
            out.append(slice(start, stop))
        return tuple(out)

    def get_tile_size(self, key) -> Tuple[int, ...]:
        """Extent of the tile(s) selected by ``key``."""
        return tuple(sl.stop - sl.start for sl in self.__tile_slices(key))

    def __getitem__(self, key) -> Optional[torch.Tensor]:
        """This rank's part of the tile(s) at ``key`` (all of it where the
        rank owns the tile), or None where it holds none of it."""
        return _local_part(self.__arr, self.__tile_slices(key))

    def __setitem__(self, key, value) -> None:
        """Overwrite the tile(s) at ``key``: each rank writes its own rows
        (no communication)."""
        self.__arr[self.__tile_slices(key)] = value


class SquareDiagTiles:
    """Tile decomposition with square tiles on the diagonal, the layout
    used by tile-wise QR/Cholesky.

    ``tiles_per_proc`` row-tiles are carved from every rank's row
    block; column boundaries mirror the row boundaries up to ``min(m, n)``
    so diagonal tiles are square, with one remainder column tile.
    Only 2-D arrays with ``split in (0, 1)`` are supported, as in the
    reference.
    """

    def __init__(self, arr: DNDarray, tiles_per_proc: int = 2) -> None:
        if not isinstance(tiles_per_proc, int) or tiles_per_proc < 1:
            raise ValueError(f"tiles_per_proc must be a positive int, got {tiles_per_proc}")
        if arr.ndim != 2:
            raise ValueError(f"SquareDiagTiles requires a 2-D DNDarray, got {arr.ndim}-D")
        if arr.split not in (0, 1):
            raise ValueError(f"SquareDiagTiles requires split 0 or 1, got {arr.split}")
        m, n = arr.gshape
        lshape_map = arr.lshape_map
        split = arr.split

        # row/col boundaries: tiles_per_proc tiles per rank block
        # along the split dim; the other dim mirrors them to stay square on
        # the diagonal, with a single remainder tile past min(m, n).
        block_sizes = lshape_map[:, split]
        bounds: List[int] = []
        pos = 0
        for b in block_sizes:
            for c in _even_chunks(int(b), tiles_per_proc):
                if c > 0:
                    pos += int(c)
                    bounds.append(pos)
        split_idx = bounds
        diag_len = min(m, n)
        split_len = m if split == 0 else n
        other_len = n if split == 0 else m

        def _diag_cut(cuts: List[int], extent: int) -> List[int]:
            """Keep cuts inside the diagonal block, force a cut exactly at
            the diagonal edge, and one remainder tile past it — so every
            diagonal tile is square (the invariant tile-wise QR/Cholesky
            needs)."""
            out = [b for b in cuts if b < diag_len] + [diag_len]
            if extent > diag_len:
                out.append(extent)
            return out

        if split == 0:
            row_bounds = _diag_cut(split_idx, split_len) if m > n else split_idx
            col_bounds = _diag_cut(split_idx, other_len)
        else:
            col_bounds = _diag_cut(split_idx, split_len) if n > m else split_idx
            row_bounds = _diag_cut(split_idx, other_len)
        self.__row_inds = [0] + row_bounds[:-1]
        self.__col_inds = [0] + col_bounds[:-1]
        self.__row_bounds = row_bounds
        self.__col_bounds = col_bounds
        self.__arr = arr
        self.__lshape_map = lshape_map

        # tile_map[r, c] = (row_start, col_start, owner)
        nrows, ncols = len(row_bounds), len(col_bounds)
        tmap = np.zeros((nrows, ncols, 3), dtype=np.int64)
        ends = np.cumsum(block_sizes)
        for r in range(nrows):
            for c in range(ncols):
                rs = self.__row_inds[r]
                cs = self.__col_inds[c]
                along = rs if split == 0 else cs
                owner = int(np.searchsorted(ends, along, side="right"))
                tmap[r, c] = (rs, cs, owner)
        self.__tile_map = tmap
        per_proc = np.zeros(arr.comm.size, dtype=np.int64)
        starts = [t[2] for t in tmap[:, 0]] if split == 0 else [t[2] for t in tmap[0, :]]
        for o in starts:
            per_proc[o] += 1
        self.__tiles_per_proc = per_proc
        diag_bound = next((i for i, b in enumerate(ends) if b >= diag_len), arr.comm.size - 1)
        self.__last_diag_pr = diag_bound

    @property
    def arr(self) -> DNDarray:
        """The tiled DNDarray."""
        return self.__arr

    @property
    def col_indices(self) -> List[int]:
        """Global start column of each tile column."""
        return list(self.__col_inds)

    @property
    def row_indices(self) -> List[int]:
        """Global start row of each tile row."""
        return list(self.__row_inds)

    @property
    def lshape_map(self) -> np.ndarray:
        """(size, 2) local shapes."""
        return self.__lshape_map

    @property
    def last_diagonal_process(self) -> int:
        """Rank of the last rank holding diagonal tiles."""
        return self.__last_diag_pr

    @property
    def tile_columns(self) -> int:
        """Number of tile columns."""
        return len(self.__col_bounds)

    @property
    def tile_columns_per_process(self) -> List[int]:
        """Tile columns owned per rank."""
        if self.__arr.split == 1:
            return [int(x) for x in self.__tiles_per_proc]
        return [self.tile_columns] * self.__arr.comm.size

    @property
    def tile_map(self) -> np.ndarray:
        """(rows, cols, 3) array of (row_start, col_start, owner)."""
        return self.__tile_map

    @property
    def tile_rows(self) -> int:
        """Number of tile rows."""
        return len(self.__row_bounds)

    @property
    def tile_rows_per_process(self) -> List[int]:
        """Tile rows owned per rank."""
        if self.__arr.split == 0:
            return [int(x) for x in self.__tiles_per_proc]
        return [self.tile_rows] * self.__arr.comm.size

    def get_start_stop(self, key) -> Tuple[int, int, int, int]:
        """(row_start, row_stop, col_start, col_stop) in global indices of
        the tile(s) at ``key``."""
        r, c = key if isinstance(key, tuple) else (key, slice(None))

        def _bounds(k, inds, bounds):
            if isinstance(k, (int, np.integer)):
                if k < 0:
                    k += len(bounds)
                return inds[k], bounds[k]
            idx = list(range(len(bounds)))[k]
            return inds[idx[0]], bounds[idx[-1]]

        r0, r1 = _bounds(r, self.__row_inds, self.__row_bounds)
        c0, c1 = _bounds(c, self.__col_inds, self.__col_bounds)
        return r0, r1, c0, c1

    def __getitem__(self, key) -> Optional[torch.Tensor]:
        """This rank's part of the tile(s) at ``key``, or None where it holds
        none of it."""
        r0, r1, c0, c1 = self.get_start_stop(key)
        return _local_part(self.__arr, (slice(r0, r1), slice(c0, c1)))

    def local_get(self, key) -> Optional[torch.Tensor]:
        """The tile(s) at ``key``, as the reference addresses them (in the
        global grid)."""
        return self[key]

    def local_set(self, key, value) -> None:
        """Overwrite the tile(s) at ``key`` (the global grid)."""
        self[key] = value

    def local_to_global(self, key, rank: int) -> Tuple[int, int]:
        """Translate a rank-local tile index into the global tile
        grid."""
        r, c = key if isinstance(key, tuple) else (key, 0)
        if self.__arr.split == 0:
            offset = int(np.sum(self.__tiles_per_proc[:rank]))
            return r + offset, c
        offset = int(np.sum(self.__tiles_per_proc[:rank]))
        return r, c + offset

    def __setitem__(self, key, value) -> None:
        """Overwrite the tile(s) at ``key``: each rank writes its own rows."""
        r0, r1, c0, c1 = self.get_start_stop(key)
        self.__arr[r0:r1, c0:c1] = value
