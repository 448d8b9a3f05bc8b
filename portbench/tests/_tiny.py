"""Tiny sizes at which the CPU tests drive whole runs of each cell."""

RENDER = {"max_bounces": 4, "bsdf": "disney", "presample_lights": 64, "coherent_tiles": 16,
          "rr_depth": 2, "rr_min_beta": 0.05, "tracer": "pallas"}


def overrides(workload: str) -> dict:
    return dict(width=64, height=36, check={"lanes": 256, "pixels": 256}, render=dict(RENDER),
                scene_params={"columns": 2, "stacks": 6, "slices": 12})
