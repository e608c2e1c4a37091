"""Faults planted in the program's timed path, for the readings that set
a limit's upper end and for the tests that see `correct` come out false:

- `unchanged`: AdamW returns the state unchanged (no update at all);
- `half_batch`: the loss sees the first half of the batch's rays, its mean
  taken over them;
- `answer`: each rendered chunk's first pixel is altered by 0.25 where
  the renderer produces it.

Each is a patch of a module-level function or class attribute of the
program; `plant` returns the callables that undo it."""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "answer")


def _half(fn, first_ray_arg: int):
    """The loss of the first half of the rays alone."""
    def half(*args):
        args = list(args)
        n2 = args[first_ray_arg].shape[0]
        for j in range(first_ray_arg, len(args)):
            a = args[j]
            if isinstance(a, torch.Tensor) and a.ndim and a.shape[0] == n2:
                args[j] = a[:n2 // 2]
        return fn(*args)
    return half


def _altered(fn):
    def altered(*args, **kw):
        out = fn(*args, **kw)
        if not kw.get("training", True):
            out["image"] = out["image"].clone()
            out["image"][0] += 0.25
        return out
    return altered


def plant(fault: str, mode: str) -> list:
    """Plant `fault` for a cell of `mode` (distill or render)."""
    from pvd_tpu_torch.engine import optim, train_steps
    undo = []

    def patch(owner, attr, new):
        old = getattr(owner, attr)
        setattr(owner, attr, new)
        undo.append(lambda: setattr(owner, attr, old))

    if fault == "unchanged":
        patch(optim.GroupedAdamW, "update_",
              lambda self, params, grads, state: None)
    elif fault == "half_batch":
        # distill_loss(student, teacher, specs, rspec, cfg, stage, occ,
        # occ_tea, o, d, bg, u, step)
        patch(train_steps, "distill_loss",
              _half(train_steps.distill_loss, 9))
    elif fault == "answer":
        patch(train_steps, "render_rays", _altered(train_steps.render_rays))
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return undo
