"""dispatch_ms.bulk: dispatch_ms.sample's reading in the bulk-generation cell, where
the sampler's rate is reported as bulk_scenes_per_s."""

from benchmark.harness import metric_module

LAYER = "sampler"
MOVES = "bulk_scenes_per_s"
read = metric_module("dispatch_ms.sample").read
