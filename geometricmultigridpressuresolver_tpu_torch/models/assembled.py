"""Assembled sparse Poisson system on the host (numpy + scipy).

The V-cycle's coarsest level is solved directly; its matrix is assembled
here from the label semantics of the reference's computeLaplacian,
independently of `ops.domain.build_level_coefficients`, so the two can check
each other.  Same code as ``geometricmultigridpressuresolver_tpu.models.
assembled``'s assembly half.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.sparse

from geometricmultigridpressuresolver_tpu_torch.grids import CellLabel, is_solvable

EXT = int(CellLabel.EXTERIOR)


def dof_indices(labels: np.ndarray) -> tuple[np.ndarray, int]:
    """Row index per solvable cell (-1 elsewhere), lexicographic scan order."""
    solvable = is_solvable(labels)
    idx = np.full(labels.shape, -1, dtype=np.int64)
    idx[solvable] = np.arange(int(solvable.sum()))
    return idx, int(solvable.sum())


def assemble_poisson(
    labels: np.ndarray, face_weights: Sequence[np.ndarray] | None = None
) -> tuple[scipy.sparse.csr_matrix, np.ndarray]:
    """Assemble the dimensionless Poisson matrix over solvable DOFs.

    Per face f (weight w_f, 1 on coarse levels) between cells a, b:
      * both solvable           -> A[a,b] -= w, A[b,a] -= w, diagonals += w
      * solvable vs DIRICHLET   -> diagonal of the solvable cell += w
      * solvable vs EXTERIOR    -> nothing
    """
    labels = np.asarray(labels)
    idx, ndof = dof_indices(labels)
    solvable = is_solvable(labels)

    rows, cols, vals = [], [], []
    diag = np.zeros(labels.shape, dtype=np.float64)
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        lo, hi = tuple(lo), tuple(hi)
        if face_weights is not None:
            interior_faces = [slice(None)] * 3
            interior_faces[axis] = slice(1, -1)
            w = np.asarray(face_weights[axis], dtype=np.float64)[tuple(interior_faces)]
        else:
            w = np.ones(labels[lo].shape, dtype=np.float64)

        la, lb = labels[lo], labels[hi]
        sa, sb = solvable[lo], solvable[hi]
        ia, ib = idx[lo], idx[hi]
        both = sa & sb
        rows += [ia[both], ib[both]]
        cols += [ib[both], ia[both]]
        vals += [-w[both], -w[both]]
        diag[lo] += np.where(sa & (lb != EXT), w, 0.0)
        diag[hi] += np.where(sb & (la != EXT), w, 0.0)

    rows.append(idx[solvable])
    cols.append(idx[solvable])
    vals.append(diag[solvable])
    a = scipy.sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(ndof, ndof),
    ).tocsr()
    return a, idx
