"""Jonker-Volgenant linear assignment (LAPJV), host-side NumPy.

JAX analog of the reference's vendored alternate LAP
backend (src/sgtd/include/lapjav.hpp:60-62, src/sgtd/src/lapjav.cpp:
column reduction -> augmenting row reduction -> augmentation via
Dijkstra-style shortest augmenting paths). The reference includes it
unused (its active graph matcher calls the scipy-port LSAP,
Semantic_Graph.hpp:440); it is provided here for API completeness and as
an independent cross-check of the other two assignment backends
(match.graph_match.auction_assignment on device, scipy in tests).

This is an original NumPy implementation of the published JV algorithm
(R. Jonker & A. Volgenant, Computing 38, 1987), not a translation of the
reference's C: the column-reduction and augmenting-row phases are
vectorized over columns, and the augmentation phase is the standard
sparse Dijkstra scan. Square or rectangular (n_rows <= n_cols) dense
costs; minimization.
"""

from __future__ import annotations

import numpy as np


def lapjv(cost: np.ndarray):
    """Solve min-cost assignment. cost (n, m) with n <= m.

    Returns (row_to_col (n,) int, col_to_row (m,) int with -1 for
    unassigned columns, total_cost float).
    """
    cost = np.asarray(cost, dtype=np.float64)
    if cost.ndim != 2:
        raise ValueError("cost must be 2-D")
    n, m = cost.shape
    if n > m:
        raise ValueError("lapjv needs n_rows <= n_cols (transpose first)")

    # Pad rectangular problems to square with a large-but-finite cost so
    # dummy assignments never displace real ones (JV's classic trick).
    if n < m:
        pad = cost.max(initial=0.0) + 1.0
        sq = np.full((m, m), pad, np.float64)
        sq[:n] = cost
        r2c, c2r, _ = lapjv(sq)
        row_to_col = r2c[:n]
        col_to_row = np.full(m, -1, np.int64)
        col_to_row[row_to_col] = np.arange(n)
        return row_to_col, col_to_row, float(cost[np.arange(n), row_to_col].sum())

    inf = np.inf
    u = np.zeros(n)  # row duals
    v = np.zeros(n)  # column duals
    row_of = np.full(n, -1, np.int64)  # column -> row
    col_of = np.full(n, -1, np.int64)  # row -> column

    # --- Column reduction (vectorized): each column's min row; assign when
    # that row is still free (scanning columns in reverse, as JV does).
    v = cost.min(axis=0)
    min_rows = cost.argmin(axis=0)
    for j in range(n - 1, -1, -1):
        i = min_rows[j]
        if col_of[i] == -1:
            col_of[i] = j
            row_of[j] = i

    # --- Augmenting row reduction for the still-free rows (two cheapest
    # reduced costs per row; standard JV pass, repeated twice).
    for _ in range(2):
        free_rows = np.where(col_of == -1)[0]
        if free_rows.size == 0:
            break
        for i in free_rows:
            red = cost[i] - v
            j1 = int(np.argmin(red))
            r1 = red[j1]
            red2 = red.copy()
            red2[j1] = inf
            j2 = int(np.argmin(red2))
            r2 = red2[j2]
            u[i] = r2
            if r1 < r2:
                v[j1] -= r2 - r1
            elif row_of[j1] != -1:
                j1 = j2
            k = row_of[j1]
            if k != -1:
                col_of[k] = -1
            col_of[i] = j1
            row_of[j1] = i

    # --- Augmentation: shortest augmenting path per remaining free row.
    for i_free in np.where(col_of == -1)[0]:
        d = cost[i_free] - v  # tentative distances
        pred = np.full(n, i_free, np.int64)
        done = np.zeros(n, bool)
        j_final = -1
        while True:
            j = int(np.argmin(np.where(done, inf, d)))
            dj = d[j]
            done[j] = True
            i = row_of[j]
            if i == -1:
                j_final = j
                break
            # Scan row i: relax through column j.
            red = dj + (cost[i] - v) - (cost[i, j] - v[j])
            better = ~done & (red < d)
            pred[better] = i
            d[better] = red[better]
        # Dual updates for scanned columns.
        scanned = done.copy()
        scanned[j_final] = False
        v[scanned] += d[scanned] - d[j_final]
        # Backtrack the alternating path.
        j = j_final
        while True:
            i = pred[j]
            row_of[j] = i
            col_of[i], j = j, col_of[i]
            if i == i_free:
                break

    total = float(cost[np.arange(n), col_of].sum())
    return col_of.copy(), row_of.copy(), total
