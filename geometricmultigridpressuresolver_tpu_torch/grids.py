"""Cell labels and grid conventions (framework-free).

Conventions used throughout the port, identical to
``geometricmultigridpressuresolver_tpu.grids``:

* Cell-centered scalar fields are arrays of shape ``(nx, ny, nz)``, z
  fastest (C order).
* Face-centered (MAC) fields are three arrays, one per axis, where the array
  for axis ``a`` has shape ``n[a] + 1`` along ``a`` and ``n`` elsewhere.
  Face ``i`` along axis ``a`` sits between cells ``i-1`` and ``i``.
* The Poisson operator is dimensionless: the interior stencil diagonal is 6,
  grid spacing ``dx`` is factored out and the caller scales the RHS by
  ``dx**2``.
"""

from __future__ import annotations

import enum


class CellLabel(enum.IntEnum):
    """Multigrid cell labels; ``label >= INTERIOR`` means "solvable"."""

    EXTERIOR = 0
    DIRICHLET = 1
    INTERIOR = 2
    BOUNDARY = 3


class MaterialLabel(enum.IntEnum):
    """Fluid material labels for the free-surface pipeline."""

    SOLID = 0
    LIQUID = 1
    AIR = 2


def is_solvable(labels):
    """Mask of cells that carry a DOF (INTERIOR or BOUNDARY); works on numpy
    arrays and torch tensors alike."""
    return labels >= int(CellLabel.INTERIOR)


def face_shape(cell_shape, axis):
    """Shape of the face array along `axis` for a given cell-grid shape."""
    shape = list(cell_shape)
    shape[axis] += 1
    return tuple(shape)

