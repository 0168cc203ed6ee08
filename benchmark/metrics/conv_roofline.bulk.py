"""conv_roofline.bulk: conv_roofline.sample's reading in the bulk-generation cell, where
the sampler's rate is reported as bulk_scenes_per_s."""

from benchmark.harness import metric_module

LAYER = "kernels"
MOVES = "bulk_scenes_per_s"
read = metric_module("conv_roofline.sample").read
