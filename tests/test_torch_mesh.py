"""pvd_tpu_torch's mesh extraction (`utils/mesh.py`) against the JAX
package's (CPU): the density sweep, marching tetrahedra and the OBJ
writer.

No JAX test covers `pvd_tpu/utils/mesh.py`; here both run on the same
inputs.  On an analytic density made of float32 adds and multiplies the
sweeps are equal, and so are the meshes: vertices, triangles and their
order (tetrahedron, then case, then cube), exactly.  On a small hash
field (float32 heads) the sweeps agree within 1e-5 x the density's max
(the MLP sums in another order), the surfaces of one grid are equal
exactly, and the end-to-end meshes have the same triangles with vertices
within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.models import field_density as j_field_density
from pvd_tpu.models import init_field as j_init_field
from pvd_tpu.utils import mesh as j_mesh
from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.params import field_from_tree
from pvd_tpu_torch.utils import mesh

torch.set_num_threads(1)

SWEEP_RTOL, VERT_ATOL = 1e-5, 1e-5
BMIN, BMAX = (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)


def _blob(p):
    """An off-centre ellipsoid with a twist, in float32 adds and
    multiplies only (numpy and torch round them alike)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return 15.0 - 20.0 * (x * x + 1.5 * y * y + 0.7 * z * z) \
        + 8.0 * x * y * z + 3.0 * y


@pytest.mark.parametrize("res,thr", [(17, 10.0), (24, 5.5)])
def test_analytic_mesh_equals_jax(res, thr, tmp_path):
    vj, tj = j_mesh.extract_geometry(
        BMIN, BMAX, res, thr, lambda p: _blob(p.astype(np.float32)))
    vt, tt = mesh.extract_geometry(BMIN, BMAX, res, thr, _blob,
                                   device="cpu", chunk=999)
    assert len(tj) > 100
    assert vt.dtype == np.float32 and tt.dtype == np.int32
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(tt, tj)
    pj, pt = str(tmp_path / "jax.obj"), str(tmp_path / "port.obj")
    j_mesh.save_obj(pj, vj, tj)
    mesh.save_obj(pt, vt, tt)
    assert open(pt).read() == open(pj).read()


def test_mesh_of_an_empty_or_full_field():
    for level in (-1.0, 100.0):
        v, t = mesh.extract_geometry(BMIN, BMAX, 9, 10.0,
                                     lambda p: p[:, 0] * 0.0 + level,
                                     device="cpu")
        assert v.shape == (0, 3) and t.shape == (0, 3)


def test_hash_field_mesh_matches_jax():
    kw = dict(model_type="hash", hash_num_levels=4, hash_log2_size=14,
              hash_desired_res=64, compute_dtype="float32")
    tree = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(2), JModelSpec(**kw)))
    tree["encoder"] = np.random.default_rng(2).uniform(
        -1, 1, tree["encoder"].shape).astype(np.float32)
    aabb = np.array(BMIN + BMAX, np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, tree)

    def j_query(p):
        return np.asarray(j_field_density(params, JModelSpec(**kw),
                                          jnp.asarray(p), jnp.asarray(aabb)))

    spec = ModelSpec(**kw)
    query = mesh.density_query(field_from_tree(tree, spec, "cpu"), spec,
                               torch.from_numpy(aabb))
    res = 20
    uj = j_mesh.extract_fields(BMIN, BMAX, res, j_query)
    ut = mesh.extract_fields(BMIN, BMAX, res, query, device="cpu",
                             chunk=1000)
    # a level through the middle of this field's densities
    thr = float(np.float32(np.percentile(uj, 70)) + np.float32(1e-3))
    assert 0.05 < float((uj > thr).mean()) < 0.95
    np.testing.assert_allclose(ut.numpy(), uj, rtol=0,
                               atol=SWEEP_RTOL * np.abs(uj).max())
    # one grid, both surfaces
    vj, tj = j_mesh.marching_tetrahedra(uj, thr)
    vt, tt = mesh.marching_tetrahedra(torch.from_numpy(uj), thr)
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_array_equal(tt.numpy(), tj)
    # end to end
    vj, tj = j_mesh.extract_geometry(BMIN, BMAX, res, thr, j_query)
    vt, tt = mesh.extract_geometry(BMIN, BMAX, res, thr, query,
                                   device="cpu")
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=VERT_ATOL)
    assert (np.abs(vt) <= 1.0).all()
