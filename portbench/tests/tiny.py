"""A cell's configuration and traffic cut to a size the CPU tests can run
(the program on its plain path); the cell's limits stay as they are."""

import copy
import json
import tempfile

from portbench import harness


def tiny_cell(name: str):
    """By the cell's name, whether BENCHMARK.json lists it or not."""
    config_name = name.split(".")[0]
    with open(harness.BENCH_DIR / "configs" / f"{config_name}.json") as f:
        config = json.load(f)
    traffic = copy.deepcopy(harness.traffic_of({"name": name}))
    config["render"]["grid_size"] = 16
    config["scene"].update(H=32, W=32)
    if traffic["driver"] == "render":
        traffic["program"].update(num_rays=256)
        traffic.update(H=32, W=32, max_ray_batch=256, orbit_views=3,
                       warmup_images=1, trace_images=2)
    else:
        config["student"]["vm_resolution"] = [24, 24, 24]
        traffic.update(num_rays=256, setup_steps=8, trace_steps=3)
    return config, traffic, harness.driver_of(traffic)


def run_cell(name: str, seed: int = 2 ** 31 + 12345):
    """Set-up, a short window, release; the runner, ready to check."""
    config, traffic, cls = tiny_cell(name)
    with tempfile.TemporaryDirectory() as workdir:
        runner = cls(config, traffic, seed, "cpu", workdir)
        runner.setup()
        res = runner.trace_window()
    runner.release()
    return runner, res, traffic["limits"]


def correct(checks: dict, limits: dict) -> bool:
    """What run.py reports as `correct` for these numbers."""
    return harness.judge(checks, limits)[0]
