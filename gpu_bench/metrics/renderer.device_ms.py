"""Device self ms a control step under the render's spans, the IK
excluded: LBS and articulation (``compose_dyn``), the fixed cameras'
dirty-tile render, the wrist pipeline, and the render's own work outside
them."""

from gpu_bench.harness.trace import stage_ms

RENDER = ("render: other", "compose_dyn", "LBS", "articulation",
          "dynamic preprocess + binning", "merge (sort)", "cache copy",
          "K2 tile_sparse (incl. cache copy)",
          "K6 tile_sparse_merge (incl. cache copy)",
          "K5 fine_sparse (incl. cache copy)", "wrist pipeline",
          "precull static", "precull dynamic", "wrist preprocess",
          "wrist binning", "wrist binning (fine)", "K1 tile_composite",
          "K4 fine_composite")


def read(run):
    return stage_ms(run, RENDER)
