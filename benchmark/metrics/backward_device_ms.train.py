"""backward_device_ms.train: forward_device_ms.train's reading for the
program's "train.backward" span: device ms a train step spends in the
kernels of loss.backward(). Autograd launches them from its own thread;
they lie inside the span in time, and the trace reader ignores threads."""

from benchmark.harness import metric_module

LAYER = "trainer"
MOVES = "train_samples_per_s"


def read(reading: dict):
    return metric_module("forward_device_ms.train").span_device_ms(reading, "train.backward")
