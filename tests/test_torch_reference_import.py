"""pvd_tpu_torch's import of the reference's PyTorch checkpoints against the
JAX package (CPU): `ops/morton.py`, `render/occupancy.to_morton_order` /
`from_morton_order` and `engine/import_torch.py`.

The reference state dicts are built here from seeded numpy draws at the
shapes of the JAX package's fields (as tests/test_import_torch.py does);
no .pth file is in the repository.  Float32 heads.

Tolerances: Morton codes, grids, bitfields and imported parameters are
exact; field outputs within 1e-5 x their max |value| (the MLPs sum in
another order); the served image within 1e-4 (as tests/test_torch_render.py
holds the eval renderer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.config import RenderSpec as JRenderSpec
from pvd_tpu.engine import import_torch as j_import
from pvd_tpu.engine.train_steps import make_eval_renderer as j_make_eval
from pvd_tpu.models import field_forward as j_field_forward
from pvd_tpu.models import init_field as j_init_field
from pvd_tpu.ops import morton as j_morton
from pvd_tpu.render import occupancy as j_occupancy
from pvd_tpu_torch.config import ModelSpec, RenderSpec
from pvd_tpu_torch.engine.import_torch import (load_torch_reference,
                                               occupancy_from_state_dict,
                                               params_from_state_dict)
from pvd_tpu_torch.engine.train_steps import make_eval_renderer
from pvd_tpu_torch.models.api import field_forward
from pvd_tpu_torch.ops.morton import morton3d, morton3d_invert
from pvd_tpu_torch.ops.rays import nerf_matrix_to_ngp
from pvd_tpu_torch.data.poses import pose_spherical
from pvd_tpu_torch.params import field_from_tree, tree_from_field
from pvd_tpu_torch.render.occupancy import (from_morton_order, grid_coords,
                                            to_morton_order)

torch.set_num_threads(1)

OUT_RTOL, IMG_TOL = 1e-5, 1e-4

SPECS = {
    "hash": dict(model_type="hash", hash_num_levels=4, hash_log2_size=14,
                 hash_desired_res=64),
    "mlp": dict(model_type="mlp", nerf_layer_num=4, nerf_layer_wide=32,
                pe_multires=4, skip=1),
    "vm": dict(model_type="vm", vm_sigma_rank=4, vm_color_rank=6,
               vm_resolution=(20, 22, 24)),
    "tensors": dict(model_type="tensors", plenoxel_res=(10, 12, 14)),
}
AABB = np.array([-1.0, -1, -1, 1, 1, 1], np.float32)


def test_morton_codes_match_jax_exhaustively():
    coords = grid_coords(32, "cpu")
    codes = morton3d(coords)
    want = np.asarray(j_morton.morton3d(jnp.asarray(coords.numpy())))
    np.testing.assert_array_equal(codes.numpy(), want.astype(np.int64))
    # a permutation of [0, 32^3), and its inverse
    assert torch.equal(torch.sort(codes).values, torch.arange(32 ** 3))
    assert torch.equal(morton3d_invert(codes), coords)
    np.testing.assert_array_equal(
        morton3d_invert(torch.arange(32 ** 3)).numpy(),
        np.asarray(j_morton.morton3d_invert(jnp.arange(32 ** 3,
                                                       dtype=jnp.uint32))))
    # bit order: x in bit 0, y in bit 1, z in bit 2, then interleaved up
    assert morton3d(torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1],
                                  [2, 0, 0], [1023, 1023, 1023]])).tolist() \
        == [1, 2, 4, 8, 2 ** 30 - 1]


@pytest.mark.parametrize("C,H", [(1, 16), (2, 32)])
def test_morton_order_round_trip_matches_jax(C, H):
    grid = np.random.default_rng(C).normal(size=(C, H, H, H)).astype(
        np.float32)
    m = to_morton_order(torch.from_numpy(grid))
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(j_occupancy.to_morton_order(jnp.asarray(grid))))
    assert torch.equal(from_morton_order(m, H), torch.from_numpy(grid))
    np.testing.assert_array_equal(
        from_morton_order(m, H).numpy(),
        np.asarray(j_occupancy.from_morton_order(jnp.asarray(m.numpy()), H)))


def _reference_sd(tree, mt: str, rng) -> dict:
    """A reference NeRFNetwork state dict (torch tensors, torch layouts) at
    the shapes of the JAX package's param tree, filled with seeded draws."""
    sd = {}

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def mlp(prefix, layers):
        for i, layer in enumerate(layers):
            sd[f"{prefix}.{i}.weight"] = draw(*np.shape(layer["w"])[::-1])
            if "b" in layer:
                sd[f"{prefix}.{i}.bias"] = draw(*np.shape(layer["b"]))

    if mt in ("hash", "mlp"):
        mlp("sigma_net", tree["sigma_net"])
        mlp("color_net", tree["color_net"])
    if mt == "hash":
        sd["encoder.embeddings"] = draw(*np.shape(tree["encoder"]))
    elif mt == "mlp":
        mlp("nerf_mlp", tree["nerf_mlp"])
    elif mt == "vm":
        for prefix in ("sigma", "color"):
            for i in range(3):
                h, w, r = np.shape(tree[f"{prefix}_mat"][i])
                sd[f"{prefix}_mat.{i}"] = draw(1, r, h, w)
                n, r = np.shape(tree[f"{prefix}_vec"][i])
                sd[f"{prefix}_vec.{i}"] = draw(1, r, n, 1)
        sd["basis_mat.weight"] = draw(*np.shape(tree["basis_mat"]["w"])[::-1])
        mlp("color_net", tree["color_net"])
    elif mt == "tensors":
        d, h, w, c = np.shape(tree["volume"])
        sd["tensor_volume.0"] = draw(1, c, d, h, w)
    if "bg" in tree:
        sd["encoder_bg.embeddings"] = draw(*np.shape(tree["bg"]["encoder"]))
        mlp("bg_net", tree["bg"]["net"])
    return sd


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("mt,bg", [("hash", False), ("hash", True),
                                   ("mlp", False), ("vm", False),
                                   ("vm", True), ("tensors", False)])
def test_params_from_state_dict_match_jax(mt, bg):
    """The imported tree equals the JAX importer's leaf for leaf, and the
    field built from it computes JAX's field."""
    kw = dict(SPECS[mt], bg_radius=4.0 if bg else -1.0,
              compute_dtype="float32")
    spec_j, spec_t = JModelSpec(**kw), ModelSpec(**kw)
    rng = np.random.default_rng(len(mt) + bg)
    sd = _reference_sd(j_init_field(jax.random.PRNGKey(0), spec_j), mt, rng)
    sd_np = {k: v.numpy() for k, v in sd.items()}
    tree_j = j_import.params_from_state_dict(sd_np, spec_j)
    tree_t = params_from_state_dict(sd, spec_t)
    _assert_trees_equal(tree_t, tree_j)
    field = field_from_tree(tree_t, spec_t, "cpu")
    _assert_trees_equal(tree_from_field(field), tree_j)
    x = rng.uniform(-0.9, 0.9, (33, 3)).astype(np.float32)
    d = rng.normal(size=(33, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    out_j = j_field_forward(jax.tree_util.tree_map(jnp.asarray, tree_j),
                            spec_j, jnp.asarray(x), jnp.asarray(d),
                            jnp.asarray(AABB))
    with torch.no_grad():
        out_t = field_forward(field, spec_t, torch.from_numpy(x),
                              torch.from_numpy(d), torch.from_numpy(AABB))
    for k in ("sigma", "rgb"):
        want = np.asarray(getattr(out_j, k))
        np.testing.assert_allclose(getattr(out_t, k).numpy(), want, rtol=0,
                                   atol=OUT_RTOL * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize("mt,bound", [("hash", 1.0), ("hash", 2.0),
                                      ("vm", 1.0)])
def test_load_torch_reference_matches_jax(mt, bound, tmp_path):
    """A checkpoint in the reference Trainer's layout through torch.save:
    the port's field holds the JAX importer's params, its state JAX's grid
    and bitfield; make_eval_renderer serves it as the JAX package's
    renderer serves JAX's import."""
    kw = dict(SPECS[mt], bound=bound, compute_dtype="float32")
    spec_j, spec_t = JModelSpec(**kw), ModelSpec(**kw)
    rs_kw = dict(bound=bound, grid_size=16, max_steps=128,
                 samples_per_ray=64.0)
    rspec_j, rspec_t = JRenderSpec(**rs_kw), RenderSpec(**rs_kw)
    rng = np.random.default_rng(7)
    sd = _reference_sd(j_init_field(jax.random.PRNGKey(1), spec_j), mt, rng)
    C, H = rspec_t.cascades, rspec_t.grid_size
    sd["density_grid"] = torch.from_numpy(
        rng.exponential(1.0, (C, H ** 3)).astype(np.float32))
    payload = {"model": sd, "global_step": 1234, "mean_density": 0.8,
               "mean_count": 42, "epoch": 3, "stats": {}}
    path = str(tmp_path / "ref.pth")
    torch.save(payload, path)

    params_j, occ_j, meta_j = j_import.load_torch_reference(path, spec_j,
                                                            rspec_j)
    field, occ_t, meta_t = load_torch_reference(path, spec_t, rspec_t,
                                                device="cpu")
    assert meta_t == meta_j == {"step": 1234, "mean_count": 42,
                                "resolution": None}
    _assert_trees_equal(tree_from_field(field), params_j)
    np.testing.assert_array_equal(occ_t.density_grid.numpy(),
                                  np.asarray(occ_j.density_grid))
    np.testing.assert_array_equal(occ_t.bitfield.numpy(),
                                  np.asarray(occ_j.bitfield))
    assert 0.2 < occ_t.bitfield.float().mean() < 0.8
    for k in ("aabb_train", "aabb_infer", "mean_density"):
        np.testing.assert_array_equal(getattr(occ_t, k).numpy(),
                                      np.asarray(getattr(occ_j, k)))
    assert occ_t.iter_density == int(occ_j.iter_density) == 16
    # the grid is the reference's Morton order: ours[x, y, z] ==
    # reference[morton(x, y, z)]
    grid_m = sd["density_grid"].numpy()
    for x, y, z in ((0, 0, 0), (3, 7, 1), (15, 15, 15), (5, 2, 9)):
        code = int(morton3d(torch.tensor([x, y, z])))
        assert occ_t.density_grid[C - 1, x, y, z] == grid_m[C - 1, code]
    # served as it is
    Hi, Wi, intr = 12, 10, (9.0, 9.0, 6.0, 5.0)
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0 * bound))
    img_j, dep_j = j_make_eval(spec_j, rspec_j, chunk=64)(
        params_j, occ_j, pose, intr, Hi, Wi)
    out = make_eval_renderer(spec_t, rspec_t, chunk=64, device="cpu")(
        field, occ_t, pose, intr, Hi, Wi)
    assert float(out.weights_sum.max()) > 0.1
    np.testing.assert_allclose(out.image.numpy(), np.asarray(img_j),
                               rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(dep_j),
                               rtol=0, atol=IMG_TOL)


def test_occupancy_from_state_dict_thresholds_at_the_lower_of_the_two():
    """bitfield = grid > min(mean_density, density_thresh)."""
    rspec = RenderSpec(grid_size=8, density_thresh=0.5)
    grid = np.linspace(0.0, 2.0, 8 ** 3, dtype=np.float32)[None]
    for mean, thresh in ((0.25, 0.25), (1.5, 0.5)):
        occ = occupancy_from_state_dict({"density_grid": grid}, rspec,
                                        mean_density=mean, device="cpu")
        want = from_morton_order(torch.from_numpy(grid), 8) > thresh
        assert torch.equal(occ.bitfield, want.reshape(-1))
