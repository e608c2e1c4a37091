"""Typed configuration (port of pvd_tpu/config.py:20-163).

Only the fields this port reads so far (the serving path, the distill
step and the teacher Trainer).  Defaults and derived properties
(`RenderSpec.cascades`, `RenderSpec.sample_budget`) are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math

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
    # vm (TensoRF-VM): plane/line ranks and per-axis resolution
    vm_sigma_rank: int = 16
    vm_color_rank: int = 48
    vm_resolution: tuple = (300, 300, 300)
    # matmul input dtype of the MLP heads ("float32" | "bfloat16")
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.model_type not in MODEL_TYPES:
            raise ValueError(f"unknown model_type {self.model_type!r}")

    @property
    def dir_sh_degree(self) -> int:
        return self.sh_degree


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
    teacher Trainer read (config.py:165-318)."""

    seed: int = 0
    iters: int = 40000
    lr: float = 1e-2
    num_rays: int = 8192
    max_steps: int = 1024
    update_extra_interval: int = 16
    max_ray_batch: int = 4096
    precision: str = "bf16"
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
    model_type: str = "hash"
    teacher_type: str = "hash"
    sigma_clip_min: float = -2.0
    sigma_clip_max: float = 7.0
    resolution0: int = 300
    upsample_model_steps: tuple = ()
    # distillation
    distill_mode: str = "no_fix_mlp"  # fix_mlp | no_fix_mlp
    loss_type: str = "L2"  # L2 | normL2 | normL1 | smoothL1
    loss_rate_rgb: float = 1.0
    loss_rate_fea_sc: float = 0.002
    loss_rate_color: float = 0.002
    loss_rate_sigma: float = 0.002
    l1_reg_weight: float = 1e-4
    ema_decay: float = -1.0
    max_samples: int = 96
    samples_per_ray: float = 16.0
    autotune_budget: bool = True
    n_devices: int = 1
    scan_steps: int = 0
    wall_budget: float = 0.0

    def model_spec(self, model_type: str | None = None) -> ModelSpec:
        return ModelSpec(
            model_type=model_type or self.model_type,
            compute_dtype=("bfloat16" if self.precision == "bf16"
                           else "float32"),
            bound=self.bound,
            sigma_clip_min=self.sigma_clip_min,
            sigma_clip_max=self.sigma_clip_max,
            vm_resolution=(self.resolution0,) * 3,
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
