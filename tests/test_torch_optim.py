"""pvd_tpu_torch's AdamW groups and schedules against the JAX package's
optax optimizer (CPU), fed identical gradients.

Identical gradients are the point: with eps 1e-15, Adam's first update is
lr * sign(g), so gradients that differ by rounding around 0 could step two
frameworks 2 * lr apart.  On identical gradients the updates agree to
float32 rounding; params are held to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.engine import optim as j_optim
from pvd_tpu.models import vm_field as j_vm
from pvd_tpu.models.api import param_group_label as j_label
from pvd_tpu.models.api import trainable_label as j_trainable
from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.engine import optim
from pvd_tpu_torch.models.api import param_group_label, trainable_label
from pvd_tpu_torch.params import vm_field_from_jax, vm_tree_from_field

torch.set_num_threads(1)

PARAM_TOL = 1e-6  # float32 rounding of the same update
SPEC_KW = dict(model_type="vm", vm_sigma_rank=4, vm_color_rank=12,
               vm_resolution=(10, 12, 14))
ITERS = 50


@pytest.mark.parametrize("distill_mode", ["no_fix_mlp", "fix_mlp"])
def test_adamw_matches_optax(distill_mode):
    spec_j, spec_t = JModelSpec(**SPEC_KW), ModelSpec(**SPEC_KW)
    tree = jax.tree_util.tree_map(
        np.asarray, j_vm.init(jax.random.PRNGKey(1), spec_j))
    j_opt = j_optim.build_optimizer(
        tree, j_label(spec_j), j_trainable(spec_j, distill_mode),
        j_optim.cosine_schedule(1e-2, ITERS),
        j_optim.cosine_schedule(1e-3, ITERS))
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_state = j_opt.init(j_params)

    field = vm_field_from_jax(tree, spec_t, "cpu")
    params = dict(field.named_parameters())
    opt = optim.build_optimizer(
        params, param_group_label(spec_t), trainable_label(spec_t,
                                                           distill_mode),
        optim.cosine_schedule(1e-2, ITERS), optim.cosine_schedule(1e-3,
                                                                  ITERS))
    state = opt.init(params)
    want_groups = {"main"} | ({"frozen", "head_lr2"}
                              if distill_mode == "fix_mlp" else {"head_lr2"})
    assert set(opt.labels.values()) == want_groups
    assert opt.labels["basis_mat"] == "head_lr2"

    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), tree)
        # a few exact zeros: Adam's update is 0 there, weight decay is not
        grads["sigma_vec"][0][:2] = 0.0
        upd, j_state = j_opt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), j_state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params, upd)
        # the same gradients in the port's layout
        g_field = vm_field_from_jax(grads, spec_t, "cpu")
        opt.update_(params, dict(g_field.named_parameters()), state)
    assert state.count == 3
    got = vm_tree_from_field(field)
    moved = 0
    for (path, w), g, p0 in zip(
            jax.tree_util.tree_flatten_with_path(j_params)[0],
            jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))
        frozen = distill_mode == "fix_mlp" and "color_net" in str(path)
        assert np.array_equal(g, p0) == frozen, path
        moved += not frozen
    assert moved >= 13


@pytest.mark.parametrize("step", [0, 1, 7, 25, 49, 50, 80])
def test_schedules_match_optax(step):
    for port, ref in ((optim.cosine_schedule(1e-2, ITERS),
                       j_optim.cosine_schedule(1e-2, ITERS)),
                      (optim.cosine_schedule(1e-3, ITERS, eta_min=1e-4),
                       j_optim.cosine_schedule(1e-3, ITERS, eta_min=1e-4)),
                      (optim.exp_decay_schedule(1e-2, ITERS),
                       j_optim.exp_decay_schedule(1e-2, ITERS))):
        np.testing.assert_allclose(port(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6)


def test_ema_update():
    e = {"a": torch.ones(3)}
    optim.ema_update(e, {"a": torch.full((3,), 3.0)}, 0.9)
    np.testing.assert_allclose(e["a"].numpy(), 1.2, rtol=1e-6)
