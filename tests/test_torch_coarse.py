"""The coarsest level's direct solver, port vs JAX, on the CPU.

The JAX package factors the coarsest level on the accelerator when the
V-cycle runs in float32 (`solver/mg.py::_finish_hierarchy`, mg.py:469-499:
`_densify` builds the identity-padded dense matrix from the scipy
triplets, `_densify_invert` inverts it up to COARSE_INVERSE_MAX_PAD
bucketed DOFs, `_densify_cholesky` factors it above), and on the host in
float64 otherwise.  The port's card path (`mg.coarse_matrix`,
`mg.coarse_system_card`, picked by `mg.coarse_on_card`) runs here on CPU
tensors, as its functions do on any device:

  * the dense float32 matrix is bit-equal to JAX `_densify` on the same
    coarsest labels (every entry an exact sum of unit weights);
  * its inverse within INV_TOL (of the largest entry) of JAX
    `_densify_invert`, and its Cholesky factor within CHOL_TOL of JAX
    `_densify_cholesky` -- two float32 LAPACK factorizations of the same
    matrix (measured on these fixtures: the inverses 6.0e-8 to 7.4e-7 apart,
    the factors 1.9e-7);
  * `coarse_solve` with the port's factor against JAX `coarse_solve` with
    JAX's, within SOLVE_TOL;
  * a whole `_finish_hierarchy` on the card path (the rule forced in both
    packages: the port's predicate, JAX's platform) against JAX's
    accelerator branch, capped, one-level and Cholesky hierarchies;
  * on the CPU, and in float64, `_finish_hierarchy` stays the host path,
    bit-equal to the JAX package's host path;
  * the rule's predicate, with no allocation on a card.

The Cholesky fixture is a 64^3 box whose level 1 holds 4352 DOFs (a bucket
just above 4096, so the CPU factorizations stay quick).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometricmultigridpressuresolver_tpu.config import SolverConfig as JaxConfig
from geometricmultigridpressuresolver_tpu.models import assembled as jax_assembled
from geometricmultigridpressuresolver_tpu.ops import domain as jax_domain
from geometricmultigridpressuresolver_tpu.solver import mg as jax_mg
from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
from geometricmultigridpressuresolver_tpu_torch.solver import mg
from tests import helpers

INV_TOL, CHOL_TOL, SOLVE_TOL = 1e-5, 1e-5, 1e-5


def _box_labels():
    """A 64^3 Dirichlet box around a 32 x 32 x 34 interior: its level 1
    has 16 * 16 * 17 = 4352 DOFs."""
    labels = np.full((64, 64, 64), helpers.DIR, dtype=np.int8)
    labels[16:48, 16:48, 14:48] = helpers.INT
    weights = helpers.unit_weights(labels)
    return jax_domain.set_boundary_labels(labels, weights), weights


@functools.cache
def _fixtures():
    """name -> (labels, face weights, mg levels, max_mg_levels), built on
    first use (not while the module is imported)."""
    sine, sine_w, sine_l = helpers.expanded_domain(helpers.sine_dirichlet_domain, 32, fractional=True)
    small, small_w, small_l = helpers.expanded_domain(helpers.sine_dirichlet_domain, 16, fractional=True)
    box, box_w = _box_labels()
    return {
        "sine32": (sine, sine_w, sine_l, None),  # 16 DOFs, bucket 256
        "sine32_cap2": (sine, sine_w, sine_l, 2),  # 1792 DOFs, bucket 1792
        "sine16_cap1": (small, small_w, small_l, 1),  # one level, fractional weights, 2048 DOFs
        "box_cap2": (box, box_w, 4, 2),  # 4352 DOFs, Cholesky
    }



@pytest.fixture(scope="module")
def coarsest():
    """name -> (port coarsest coefficients with unit weights, coarsest
    labels as numpy, ndof, nd_pad); built once per fixture."""
    cache = {}

    def get(name):
        if name not in cache:
            labels, weights, levels, cap = _fixtures()[name]
            target = levels if cap is None else min(levels, cap)
            lab = torch.from_numpy(labels).to(torch.int8)
            built, _, label_levels, _ = mg._build_levels(lab, None, target, 1, torch.float32)
            ndof = int(built[-1].solvable.sum())
            cache[name] = (built[-1], label_levels[-1].numpy(), ndof, mg.coarse_bucket(ndof))
        return cache[name]

    return get


def _jax_triplets(labels):
    """The JAX accelerator branch's arguments (mg.py:483-494): the scipy
    matrix's COO triplets bucketed to 4096 entries, as device arrays."""
    a, _ = jax_assembled.assemble_poisson(labels, None)
    coo = a.tocoo()
    nnz_pad = -(-coo.nnz // 4096) * 4096
    rows, cols = np.zeros(nnz_pad, np.int32), np.zeros(nnz_pad, np.int32)
    vals = np.zeros(nnz_pad, np.float32)
    rows[: coo.nnz], cols[: coo.nnz], vals[: coo.nnz] = coo.row, coo.col, coo.data
    return jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), jnp.int32(a.shape[0])


def _gap(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, dtype=np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["sine32", "sine32_cap2", "box_cap2"])
def test_card_matrix_bit_equal_to_jax_densify(coarsest, name):
    c, labels, ndof, nd_pad = coarsest(name)
    a, dofs, nd = mg.coarse_matrix(c, nd_pad)
    want = np.asarray(jax_mg._densify(*_jax_triplets(labels), nd_pad))
    assert a.dtype == torch.float32 and a.shape == (nd_pad, nd_pad) and int(nd) == ndof
    assert np.array_equal(a.numpy().view(np.int32), want.view(np.int32))
    idx = jax_assembled.dof_indices(labels)[0].ravel()
    want_dofs = np.pad(np.flatnonzero(idx >= 0), (0, nd_pad - ndof), constant_values=idx.size)
    assert np.array_equal(dofs.numpy(), want_dofs)


def test_one_level_matrix_ignores_face_weights():
    """A one-level hierarchy's coarsest level is the finest, whose own
    coefficients carry the face weights; the coarse system (JAX assembles
    it with unit weights) comes from coefficients rebuilt without them."""
    labels, weights, _, _ = _fixtures()["sine16_cap1"]
    lab = torch.from_numpy(labels).to(torch.int8)
    fw = tuple(torch.from_numpy(w).float() for w in weights)
    weighted = mg._level_coeffs(lab, fw, 1, torch.float32, None)
    unit = mg._level_coeffs(lab, None, 1, torch.float32, None)
    nd_pad = mg.coarse_bucket(int(unit.solvable.sum()))
    want = np.asarray(jax_mg._densify(*_jax_triplets(labels), nd_pad))
    assert np.array_equal(mg.coarse_matrix(unit, nd_pad)[0].numpy().view(np.int32), want.view(np.int32))
    assert not torch.equal(mg.coarse_matrix(weighted, nd_pad)[0], torch.tensor(want))


@pytest.mark.parametrize("name", ["sine32", "sine32_cap2"])
def test_card_inverse_matches_jax_densify_invert(coarsest, name):
    c, labels, ndof, nd_pad = coarsest(name)
    dofs, minv, chol = mg.coarse_system_card(c, nd_pad)
    want = jax_mg._densify_invert(*_jax_triplets(labels), nd_pad)
    assert chol.shape == (0, 0) and minv.shape == (nd_pad, nd_pad) and minv.dtype == torch.float32
    assert torch.equal(minv, minv.T)
    assert _gap(minv.numpy(), want) <= INV_TOL


def test_card_cholesky_matches_jax_densify_cholesky(coarsest):
    c, labels, ndof, nd_pad = coarsest("box_cap2")
    assert mg.COARSE_INVERSE_MAX_PAD < nd_pad <= 6144
    dofs, minv, chol = mg.coarse_system_card(c, nd_pad)
    want = jax_mg._densify_cholesky(*_jax_triplets(labels), nd_pad)
    assert minv.shape == (0, 0) and chol.shape == (nd_pad, nd_pad) and chol.dtype == torch.float32
    assert bool(torch.isfinite(chol).all()) and torch.equal(chol, chol.tril())
    assert _gap(chol.numpy(), want) <= CHOL_TOL
    # coarse_solve with each package's factor, on the same random field.
    shape = labels.shape
    solv = jax_assembled.dof_indices(labels)[0] >= 0
    r = np.where(solv, np.random.default_rng(3).standard_normal(shape), 0.0).astype(np.float32)
    jh = jax_mg.MGHierarchy(levels=(), coarse_dofs=jnp.asarray(dofs.numpy().astype(np.int32)),
                            coarse_minv=jnp.zeros((0, 0), jnp.float32), coarse_chol=want)
    th = mg.MGHierarchy(levels=(), coarse_dofs=dofs, coarse_minv=minv, coarse_chol=chol)
    want_x = np.asarray(jax_mg.coarse_solve(jh, jnp.asarray(r)))
    got_x = mg.coarse_solve(th, torch.from_numpy(r)).numpy()
    assert _gap(got_x, want_x) <= SOLVE_TOL
    assert (got_x[~solv] == 0).all()


def test_failed_cholesky_is_nan():
    """A matrix that is not positive definite: the factor is all NaN, as
    the JAX package's is, and no error is raised (the card path reads no
    `info`)."""
    c = mg._level_coeffs(torch.from_numpy(_fixtures()["sine32"][0]).to(torch.int8), None, 1, torch.float32, None)
    c = c._replace(diag=-c.diag)  # 16384 DOFs: the bucket overflows into the dump
    nd_pad = mg.COARSE_INVERSE_MAX_PAD + 256
    _, _, chol = mg.coarse_system_card(c, nd_pad)
    assert chol.shape == (nd_pad, nd_pad) and bool(torch.isnan(chol).all())


@pytest.mark.parametrize("name", ["sine32", "sine16_cap1", "box_cap2"])
def test_finish_hierarchy_card_path_matches_jax_accelerator_branch(monkeypatch, name):
    """Both rules forced to the card on the CPU (the port's predicate, the
    JAX package's platform): the same levels, slot map and factor kind, and
    the factor within the tolerances above."""
    labels, weights, levels, cap = _fixtures()[name]
    with monkeypatch.context() as m:
        m.setattr(mg, "coarse_on_card", lambda device, dtype: True)
        th = mg.build_hierarchy(labels, weights, levels, SolverConfig(mg_dtype=torch.float32, max_mg_levels=cap),
                                device="cpu")
    with monkeypatch.context() as m:
        m.setattr(jax, "devices", lambda *a, **k: [types.SimpleNamespace(platform="gpu")])
        jh = jax_mg.build_hierarchy(labels, weights, levels, JaxConfig(mg_dtype=jnp.float32, max_mg_levels=cap))
    assert th.num_levels == jh.num_levels
    assert np.array_equal(th.coarse_dofs.numpy(), np.asarray(jh.coarse_dofs))
    for got, want, tol in ((th.coarse_minv, jh.coarse_minv, INV_TOL), (th.coarse_chol, jh.coarse_chol, CHOL_TOL)):
        assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
        if got.numel():
            assert _gap(got.numpy(), want) <= tol


@pytest.mark.parametrize("name,dtype", [("sine32", torch.float32), ("sine32", torch.float64),
                                        ("sine16_cap1", torch.float32), ("box_cap2", torch.float64)])
def test_finish_hierarchy_host_path_bit_equal_to_jax(name, dtype):
    """On the CPU (float32 or float64) and in float64 the port keeps the host
    path: the factor bit-equal to the JAX package's host path."""
    labels, weights, levels, cap = _fixtures()[name]
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    th = mg.build_hierarchy(labels, weights, levels, SolverConfig(mg_dtype=dtype, max_mg_levels=cap), device="cpu")
    jh = jax_mg.build_hierarchy(labels, weights, levels, JaxConfig(mg_dtype=jdtype, max_mg_levels=cap))
    assert np.array_equal(th.coarse_dofs.numpy(), np.asarray(jh.coarse_dofs))
    for got, want in ((th.coarse_minv, jh.coarse_minv), (th.coarse_chol, jh.coarse_chol)):
        assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert (th.coarse_chol.numel() > 0) == (name == "box_cap2")


@pytest.mark.parametrize("device,dtype,card", [
    ("cuda", torch.float32, True), ("cuda:1", torch.float32, True), (torch.device("cuda", 0), torch.float32, True),
    ("cuda", torch.float64, False), ("cpu", torch.float32, False), ("cpu", torch.float64, False),
])
def test_rule_predicate(device, dtype, card):
    assert mg.coarse_on_card(device, dtype) is card


def test_bucket_and_refusal():
    assert [mg.coarse_bucket(n) for n in (0, 1, 256, 257, 4096, 4097, 16384)] == [0, 256, 256, 512, 4096, 4352, 16384]
    with pytest.raises(ValueError, match="16385 DOFs"):
        mg.coarse_bucket(16385)
