"""The port's copy of the generated protobuf bindings of
drivescenegen_tpu/data/protos/ (the public Waymo Motion schema subset).

Regenerate with:  cd drivescenegen_torch/data/protos && protoc --python_out=. *.proto
then make dsg_scenario_pb2.py's `import dsg_map_pb2` package-relative
(`from . import dsg_map_pb2`), so that it never resolves to another
directory's copy through sys.path. Both packages register the same
descriptors in protobuf's default pool, which accepts an identical file
twice.
"""

from . import dsg_map_pb2, dsg_scenario_pb2  # noqa: F401
