"""idle_share.bulk: idle_share.sample's reading in the bulk-generation cell, where
the sampler's rate is reported as bulk_scenes_per_s."""

from benchmark.harness import metric_module

LAYER = "device"
MOVES = "bulk_scenes_per_s"
read = metric_module("idle_share.sample").read
