"""forward_device_ms.bulk: forward_device_ms.sample's reading in the bulk-generation cell, where
the sampler's rate is reported as bulk_scenes_per_s."""

from benchmark.harness import metric_module

LAYER = "model"
MOVES = "bulk_scenes_per_s"
read = metric_module("forward_device_ms.sample").read
