"""Cells cut to a size the CPU runs in a fraction of a second a step: a
120-particle rope (or the T at a 3 cm grid), 500 body splats, 3,000 table
splats, 50 splats a link, 64x128 cameras, 4 lanes, 133 substeps of 0.25 ms
(springs softened to Y = 500 for that step)."""

import argparse

from gpu_bench.harness import cell as cell_mod


def shrink(cell, lanes: int = 4):
    s = cell.spec
    if "particles" in s["object"]:
        s["object"]["particles"] = 120
    else:
        s["object"]["grid_size"] = 0.03
        s["object"]["n_surface"] = 150
        s["object"]["max_neighbours"] = 12
        s["physics"]["object_max_neighbours"] = 12
    s["object"]["body_splats"] = 500
    s["object"]["spring_Y"] = 500.0
    s["physics"]["dt"] = 2.5e-4
    s["scan"]["table_splats"] = 3000
    s["scan"]["splats_per_link"] = 50
    for cam in s["env"]["cameras"]:
        cam["h"], cam["w"] = 64, 128
        cam["intr"] = [60.0, 0.0, 64.0, 0.0, 60.0, 32.0, 0.0, 0.0, 1.0]
    cell.traffic["lanes"] = lanes
    return cell


def tiny(workload: str, **kw):
    return shrink(cell_mod.find(workload, **kw))


def args(workload: str, seed: int = 2**31 + 7, seconds: float = 1.0,
         trace: int = 0, control: int = 0):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace, control=control)

