"""quantize_idle_ms.bulk: quantize_idle_ms.sample's reading in the
bulk-generation cells, where the sampler's rate is reported as
bulk_scenes_per_s."""

from benchmark.harness import metric_module

LAYER = "sampler"
MOVES = "bulk_scenes_per_s"
read = metric_module("quantize_idle_ms.sample").read
