"""Field-network interface over the four architectures (port of
pvd_tpu/models/api.py:52-99).

The hash and VM fields are ported; the others raise with the ROADMAP item
that ports them.  Parameter paths are the port's parameter names split at
the dots (`planes.0`, `basis_mat`, `color_net.1.weight`): their first
element names the same part as the JAX package's pytree path.
"""

from __future__ import annotations

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.models.heads import FieldOut

_PENDING = {
    "mlp": "ROADMAP A12 (other fields)",
    "tensors": "ROADMAP A12 (other fields)",
}


def _check(spec: ModelSpec):
    if spec.model_type not in ("hash", "vm"):
        raise NotImplementedError(
            f"model_type {spec.model_type!r} is not ported yet: "
            f"{_PENDING[spec.model_type]}")


def field_forward(field, spec: ModelSpec, x, d, aabb,
                  want_color: bool = True) -> FieldOut:
    """x: [N, 3] in [-bound, bound]; d: [N, 3] unit directions.  The hash
    field ignores `aabb` (it uses the cubic bound); the VM field maps x
    through it."""
    _check(spec)
    if spec.model_type == "vm":
        return field(x, d, aabb, want_color)
    return field(x, d, want_color)


def field_density(field, spec: ModelSpec, x, aabb):
    """Density-only query for occupancy-grid upkeep."""
    _check(spec)
    if spec.model_type == "vm":
        return field.density(x, aabb)
    return field.density(x)


def param_group_label(spec: ModelSpec):
    """fn(path) -> 'main' | 'head_lr2' (api.py:63-76): only the VM field
    puts its color_net and basis_mat on the secondary learning rate."""

    def label(path) -> str:
        if spec.model_type == "vm" and path and \
                path[0] in ("color_net", "basis_mat"):
            return "head_lr2"
        return "main"

    return label


def trainable_label(spec: ModelSpec, distill_mode: str):
    """fn(path) -> bool (api.py:79-94): fix_mlp freezes the shared heads
    (sigma_net, color_net) and trains everything else."""

    def is_trainable(path) -> bool:
        if distill_mode != "fix_mlp":
            return True
        return not (path and path[0] in ("sigma_net", "color_net"))

    return is_trainable


def vm_density_l1(field):
    """L1 regularizer over the VM sigma planes and lines (api.py:97-99)."""
    return field.density_l1()
