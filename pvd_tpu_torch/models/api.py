"""Field-network interface over the four architectures (port of
pvd_tpu/models/api.py:52-60).

Only the hash field is ported; the others raise with the ROADMAP item that
ports them.
"""

from __future__ import annotations

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.models.heads import FieldOut

_PENDING = {
    "vm": "ROADMAP A5 (VM field, with the distill step)",
    "mlp": "ROADMAP A12 (other fields)",
    "tensors": "ROADMAP A12 (other fields)",
}


def _check(spec: ModelSpec):
    if spec.model_type != "hash":
        raise NotImplementedError(
            f"model_type {spec.model_type!r} is not ported yet: "
            f"{_PENDING[spec.model_type]}")


def field_forward(field, spec: ModelSpec, x, d, aabb,
                  want_color: bool = True) -> FieldOut:
    """x: [N, 3] in [-bound, bound]; d: [N, 3] unit directions.  The hash
    field ignores `aabb` (it uses the cubic bound)."""
    _check(spec)
    return field(x, d, want_color)


def field_density(field, spec: ModelSpec, x, aabb):
    """Density-only query for occupancy-grid upkeep."""
    _check(spec)
    return field.density(x)
