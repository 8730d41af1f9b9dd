"""LOMS setup arrays — the paper's Appendix A, implemented literally (a
copy of ``repro.core.setup_array``: numpy only, so the port keeps its own).

A setup array is a small 2-D grid of cells; each populated cell names one
element of one sorted input list. Column index 0 is the RIGHTMOST column
(paper convention); row 0 is the BOTTOM row. Value index 0 of every list is
its minimum (ascending lists — the paper indexes _00 = min up to _NN = max,
identical convention).

Construction (k-way, Appendix A):
  1. lists are laid out top-down, each list's block below the previous;
     within a block, values DESCEND row-major left->right; list ``l`` starts
     ``l`` columns further right (the "offset"), overflowing into virtual
     columns right of col 0;
  2. virtual-column overflow wraps ``k`` columns left into the same row;
  3. per column, populated cells slide UP, holes collect at the bottom;
  4. fully-empty bottom rows are removed.

The 2-column 2-way array is the k=2 case of the same construction. Multi-
column 2-way arrays (Section IV, Fig. 4) use the UP/DN orientation rule:
the A (UP) block fills top rows, ascending right->left then upward; the
B (DN) block fills bottom rows mirrored, ascending left->right then upward.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

HOLE = (-1, -1)


@dataclasses.dataclass(frozen=True)
class SetupArray:
    """grid[r][c] = (list_id, value_index) or HOLE. r=0 bottom, c=0 RIGHT."""

    lens: Tuple[int, ...]
    n_cols: int
    grid: Tuple[Tuple[Tuple[int, int], ...], ...]  # grid[row][col]

    @property
    def n_rows(self) -> int:
        return len(self.grid)

    def cell_flat(self, r: int, c: int) -> int:
        """Flat working-vector index of cell (r, c)."""
        return r * self.n_cols + c

    @property
    def size(self) -> int:
        return self.n_rows * self.n_cols

    def populated(self, r: int, c: int) -> bool:
        return self.grid[r][c] != HOLE

    def input_position(self, list_id: int, value_idx: int) -> int:
        """Position in the concatenated input vector [list0..listk-1]."""
        return int(sum(self.lens[:list_id]) + value_idx)

    # -- derived mappings ---------------------------------------------------

    def setup_scatter(self) -> Tuple[int, ...]:
        """For input position p -> flat working cell index."""
        out = [None] * sum(self.lens)
        for r in range(self.n_rows):
            for c in range(self.n_cols):
                cell = self.grid[r][c]
                if cell != HOLE:
                    out[self.input_position(*cell)] = self.cell_flat(r, c)
        assert all(v is not None for v in out)
        return tuple(out)

    def rowmajor_output_gather(self) -> Tuple[int, ...]:
        """Ascending read-out: bottom row up, right->left (col0 first). k=2."""
        out = []
        for r in range(self.n_rows):
            for c in range(self.n_cols):
                if self.populated(r, c):
                    out.append(self.cell_flat(r, c))
        return tuple(out)

    def serpentine_output_gather(self) -> Tuple[int, ...]:
        """Ascending serpentine read-out (k>=3): even rows right->left,
        odd rows left->right (paper Fig. 5)."""
        out = []
        for r in range(self.n_rows):
            cols = range(self.n_cols) if r % 2 == 0 else range(self.n_cols - 1, -1, -1)
            for c in cols:
                if self.populated(r, c):
                    out.append(self.cell_flat(r, c))
        return tuple(out)

    # -- group extraction ---------------------------------------------------

    def column_cells(self, c: int) -> List[Tuple[int, Tuple[int, int]]]:
        """Populated (flat_idx, content) of column c, bottom -> top."""
        return [
            (self.cell_flat(r, c), self.grid[r][c])
            for r in range(self.n_rows)
            if self.populated(r, c)
        ]

    def stage1_column_runs(self, c: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(cell indices bottom->top, run lengths) for the stage-1 column
        merge. Within a column the cells of one list appear in ascending
        order bottom->top (a consequence of the setup construction), so runs
        are the maximal same-list segments."""
        cells = self.column_cells(c)
        idx = tuple(f for f, _ in cells)
        runs: List[int] = []
        prev_list: Optional[int] = None
        prev_val: Optional[int] = None
        for _, (lst, val) in cells:
            if lst == prev_list and prev_val is not None and val > prev_val:
                runs[-1] += 1
            else:
                runs.append(1)
            prev_list, prev_val = lst, val
        return idx, tuple(runs)

    def row_cells(self, r: int, ascending_right_to_left: bool) -> Tuple[int, ...]:
        """Populated cells of row r in ascending output order."""
        cols = range(self.n_cols) if ascending_right_to_left else range(self.n_cols - 1, -1, -1)
        return tuple(self.cell_flat(r, c) for c in cols if self.populated(r, c))


def _compact_columns_and_trim(cells: np.ndarray) -> np.ndarray:
    """Step 3+4: per column slide populated cells up; drop empty bottom rows.

    ``cells``: (R, C, 2) int array, HOLE = (-1,-1); row 0 = bottom."""
    r_, c_, _ = cells.shape
    out = np.full_like(cells, -1)
    for c in range(c_):
        col = [cells[r, c] for r in range(r_) if cells[r, c][0] >= 0]
        # populated cells keep their bottom->top order, pushed to the top
        start = r_ - len(col)
        for i, v in enumerate(col):
            out[start + i, c] = v
    # drop fully-empty rows (they can only be at the bottom now)
    keep = [(out[r] >= 0).any() for r in range(r_)]
    return out[np.asarray(keep, dtype=bool)]


def build_kway_setup(lens: Sequence[int]) -> SetupArray:
    """Appendix-A construction for k lists into a k-column array."""
    lens = tuple(int(x) for x in lens)
    k = len(lens)
    assert k >= 2 and all(l >= 1 for l in lens)
    blocks = []
    for l_id, ln in enumerate(lens):
        rows_needed = -(-(ln) // k) + 1  # slack row for offset overflow
        block = np.full((rows_needed, k, 2), -1, dtype=np.int64)
        for d in range(ln):  # d = descending position, d=0 is the max
            val = ln - 1 - d
            row_top_down = d // k
            col = ((k - 1 - l_id) - (d % k)) % k  # offset + wrap (steps 1+2)
            # rows are stored bottom-up; convert top-down block row
            block[rows_needed - 1 - row_top_down, col] = (l_id, val)
        # trim unused rows inside the block
        used = [(block[r] >= 0).any() for r in range(rows_needed)]
        blocks.append(block[np.asarray(used, dtype=bool)])
    # stack: list 0 on top (highest rows), last list at the bottom
    cells = np.concatenate(list(reversed(blocks)), axis=0)
    cells = _compact_columns_and_trim(cells)
    grid = tuple(
        tuple((int(cells[r, c, 0]), int(cells[r, c, 1])) for c in range(k))
        for r in range(cells.shape[0])
    )
    return SetupArray(lens=lens, n_cols=k, grid=grid)


def build_2way_setup(m: int, n: int, n_cols: int = 2) -> SetupArray:
    """Section-IV 2-way setup: UP list A (m values) above DN list B (n
    values), in ``n_cols`` columns. For n_cols == 2 this coincides with the
    k=2 Appendix-A construction (verified in tests)."""
    assert m >= 1 and n >= 1 and n_cols >= 2
    c_ = n_cols
    a_rows = -(-m // c_)
    b_rows = -(-n // c_)
    cells = np.full((a_rows + b_rows, c_, 2), -1, dtype=np.int64)
    # Both blocks fill DESCENDING row-major from their top row (paper Fig. 1).
    # A (UP) block, top rows: max at top-LEFT, each row descends left->right.
    for d in range(m):  # d = descending position, d=0 is the max
        row = b_rows + (a_rows - 1 - d // c_)
        cells[row, c_ - 1 - (d % c_)] = (0, m - 1 - d)
    # B (DN) block, bottom rows: max at top-RIGHT, each row descends
    # right->left (the DN mirror orientation).
    for d in range(n):
        row = b_rows - 1 - d // c_
        cells[row, d % c_] = (1, n - 1 - d)
    cells = _compact_columns_and_trim(cells)
    grid = tuple(
        tuple((int(cells[r, c, 0]), int(cells[r, c, 1])) for c in range(c_))
        for r in range(cells.shape[0])
    )
    return SetupArray(lens=(m, n), n_cols=c_, grid=grid)
