"""Typed configuration (port of pvd_tpu/config.py:20-328).

Only the fields this port reads so far (the serving path, the distill
step, the teacher and distill Trainer, its checkpoints, the background
model, both CLIs and the four fields).  Defaults and derived properties
(`RenderSpec.cascades`, `RenderSpec.sample_budget`) are the JAX package's.
`PVDConfig.to_json` / `from_json` read and write the checkpoint's
`config_json` and the CLI's `args.json`.  A JAX config that sets one of
the JAX package's options the port lacks (`UNPORTED`) to anything but its
default raises NotImplementedError with the option's ROADMAP item; other
keys the port lacks are dropped, as the JAX package drops unknown keys:
among them the JAX package's `tensorboard` switch (the port writes no
event files).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

MODEL_TYPES = ("hash", "mlp", "vm", "tensors")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static architecture of one field network (config.py:20-92)."""

    model_type: str = "hash"
    bound: float = 1.0
    sigma_clip_min: float = -2.0
    sigma_clip_max: float = 7.0
    geo_feat_dim: int = 15
    num_layers: int = 2
    hidden_dim: int = 64
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    hash_num_levels: int = 14
    hash_level_dim: int = 2
    hash_base_res: int = 16
    hash_log2_size: int = 19
    hash_desired_res: int = 2048
    # the finest N hashed levels store a cell's 8 corners in one row of a
    # separate cell table (ops/hashgrid.py); 0 = exact mode
    hash_cell_levels: int = 0
    # a FROZEN field (the distill teacher) evaluates every dense level from
    # one table on the finest dense level's lattice, baked once
    # (ops/hashgrid.build_baked_dense); exact for the finest dense level,
    # the coarser ones resampled onto its vertices
    hash_bake_dense: bool = False
    # mlp (NeRF): PE(pe_multires) input, nerf_layer_num x nerf_layer_wide
    # layers with biases, the encoded input concatenated after layer `skip`
    pe_multires: int = 10
    nerf_layer_num: int = 8
    nerf_layer_wide: int = 256
    skip: int = 3
    # vm (TensoRF-VM): plane/line ranks and per-axis resolution
    vm_sigma_rank: int = 16
    vm_color_rank: int = 48
    vm_resolution: tuple = (300, 300, 300)
    # tensors (Plenoxels): SH degree of the dense volume's color channels
    # and its (D, H, W) resolution
    plenoxel_degree: int = 3
    plenoxel_res: tuple = (128, 128, 128)
    # background sphere model (bg_radius > 0 enables it, for any field)
    bg_radius: float = -1.0
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    # matmul input dtype of the MLP heads ("float32" | "bfloat16")
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.model_type not in MODEL_TYPES:
            raise ValueError(f"unknown model_type {self.model_type!r}")

    @property
    def dir_sh_degree(self) -> int:
        """Direction-encoder SH degree: plenoxels carry their own SH lobe
        (config.py:85-88)."""
        return (self.plenoxel_degree if self.model_type == "tensors"
                else self.sh_degree)

    @property
    def plenoxel_fea_dim(self) -> int:
        """Channels of the plenoxel volume: the sigma logit, then 3 x deg^2
        SH coefficients (config.py:90-92)."""
        return 3 * self.plenoxel_degree ** 2 + 1


@dataclasses.dataclass(frozen=True)
class RenderSpec:
    """Static renderer settings (config.py:95-162)."""

    bound: float = 1.0
    min_near: float = 0.2
    density_thresh: float = 10.0
    density_scale: float = 1.0
    grid_size: int = 128
    dt_gamma: float = 0.0
    max_steps: int = 1024
    max_samples: int = 96
    samples_per_ray: float = 0.0

    @property
    def cascades(self) -> int:
        return 1 + max(0, math.ceil(math.log2(self.bound)))

    def sample_budget(self, n_rays: int) -> int:
        """Compacted-point count for a batch (multiple of 128); 0 = off."""
        if self.samples_per_ray <= 0:
            return 0
        m = int(round(n_rays * self.samples_per_ray))
        m = max(128, (m + 127) // 128 * 128)
        return min(m, n_rays * self.max_samples)


@dataclasses.dataclass
class PVDConfig:
    """The experiment fields the serving path, the distill step and the
    Trainer read (config.py:165-318)."""

    path: str = ""
    workspace: str = "workspace"
    seed: int = 0
    iters: int = 40000
    lr: float = 1e-2
    ckpt: str = "latest"
    num_rays: int = 8192
    max_steps: int = 1024
    update_extra_interval: int = 16
    max_ray_batch: int = 4096
    precision: str = "bf16"
    mode: str = "blender"
    color_space: str = "srgb"
    preload: bool = True
    bound: float = 1.0
    scale: float = 0.8
    dt_gamma: float = 0.0
    min_near: float = 0.2
    density_thresh: float = 10.0
    bg_radius: float = -1.0
    grid_size: int = 128
    error_map: bool = False
    # <0 no random-pose augmentation; 0 only random orbit poses; >0 one
    # orbit pose per `rand_pose` scheduled poses (distillation only)
    rand_pose: int = -1
    data_type: str = "synthetic"  # synthetic | llff | tank
    downscale: int = 1
    model_type: str = "hash"
    teacher_type: str = "hash"
    sigma_clip_min: float = -2.0
    sigma_clip_max: float = 7.0
    PE: int = 10
    nerf_layer_num: int = 8
    nerf_layer_wide: int = 256
    skip: int = 3
    resolution0: int = 300
    resolution1: int = 300
    upsample_model_steps: tuple = ()
    plenoxel_degree: int = 3
    plenoxel_res: tuple = (128, 128, 128)
    # distillation
    distill_mode: str = "no_fix_mlp"  # fix_mlp | no_fix_mlp
    stage1_iters: int = 2000
    stage2_iters: int = 5000
    loss_type: str = "L2"  # L2 | normL2 | normL1 | smoothL1
    loss_rate_rgb: float = 1.0
    loss_rate_fea_sc: float = 0.002
    loss_rate_color: float = 0.002
    loss_rate_sigma: float = 0.002
    l1_reg_weight: float = 1e-4
    ema_decay: float = -1.0
    ckpt_teacher: str = ""
    ckpt_student: str = ""
    update_stu_extra: bool = False  # refresh student occupancy in distill
    enable_edit_plenoxel: bool = False  # plenoxel region-erase demo
    max_samples: int = 96
    samples_per_ray: float = 16.0
    autotune_budget: bool = True
    n_devices: int = 1
    scan_steps: int = 0
    # the JAX package's mesh layout: declared there (config.py:254) and
    # never read; carried here unused
    mesh_shape: Optional[tuple] = None
    hash_cell_levels: int = 0
    hash_bake_dense: bool = False  # bake the frozen teacher's dense levels
    eval_interval: int = 50  # epochs between evaluations on valid_ds
    # wall-clock budget of Trainer.train in seconds (0 = none): once spent,
    # training ends at the next epoch boundary with the normal final
    # checkpoint and eval
    wall_budget: float = 0.0

    def __post_init__(self):
        if isinstance(self.plenoxel_res, str):
            self.plenoxel_res = json.loads(self.plenoxel_res)
        self.plenoxel_res = tuple(self.plenoxel_res)
        self.upsample_model_steps = tuple(self.upsample_model_steps)
        if self.mesh_shape is not None:
            self.mesh_shape = tuple(self.mesh_shape)

    def model_spec(self, model_type: str | None = None) -> ModelSpec:
        return ModelSpec(
            model_type=model_type or self.model_type,
            compute_dtype=("bfloat16" if self.precision == "bf16"
                           else "float32"),
            bound=self.bound,
            sigma_clip_min=self.sigma_clip_min,
            sigma_clip_max=self.sigma_clip_max,
            pe_multires=self.PE,
            nerf_layer_num=self.nerf_layer_num,
            nerf_layer_wide=self.nerf_layer_wide,
            skip=self.skip,
            vm_resolution=(self.resolution0,) * 3,
            plenoxel_degree=self.plenoxel_degree,
            # a plenoxel upsample schedule starts the volume at
            # resolution0^3 (config.py:293-300)
            plenoxel_res=((self.resolution0,) * 3
                          if (self.model_type == "tensors"
                              and self.upsample_model_steps)
                          else tuple(self.plenoxel_res)),
            hash_cell_levels=self.hash_cell_levels,
            hash_bake_dense=self.hash_bake_dense,
            bg_radius=self.bg_radius,
        )

    def render_spec(self) -> RenderSpec:
        return RenderSpec(
            bound=self.bound,
            min_near=self.min_near,
            density_thresh=self.density_thresh,
            grid_size=self.grid_size,
            dt_gamma=self.dt_gamma,
            max_steps=self.max_steps,
            max_samples=self.max_samples,
            samples_per_ray=self.samples_per_ray,
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, raw: dict) -> "PVDConfig":
        """The config of `raw`'s fields; raises NotImplementedError for an
        `UNPORTED` option set to anything but the JAX package's default,
        and drops keys that neither package has."""
        for name, value in raw.items():
            if name in UNPORTED:
                default, item = UNPORTED[name]
                got = tuple(value) if isinstance(value, list) else value
                if got != default:
                    raise NotImplementedError(
                        f"PVDConfig: {name}={value!r} is not ported yet "
                        f"(ROADMAP {item}; the default is {default!r})")
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})

    @classmethod
    def from_json(cls, text: str) -> "PVDConfig":
        return cls.from_dict(json.loads(text))


# the JAX package's PVDConfig fields the port does not have yet: their
# JAX defaults and ROADMAP items
UNPORTED = {
    "num_steps": (512, "A14"),
    "upsample_steps": (0, "A14"),
}
