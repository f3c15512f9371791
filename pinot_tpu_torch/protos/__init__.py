"""Wire contracts of the gRPC data plane and the multi-stage dispatch.

Port of ``pinot_tpu/protos/``. ``server_pb2.py`` and ``plan_pb2.py`` are
vendored protoc output (protoc 3.21 gencode) whose serialized
descriptors are byte-equal to the reference's, so both packages can
register ``server.proto`` and ``plan.proto`` in protobuf's default pool
in one process. Regenerate with:

    protoc --python_out=pinot_tpu_torch/protos -I pinot_tpu_torch/protos \
        pinot_tpu_torch/protos/server.proto pinot_tpu_torch/protos/plan.proto
"""
from . import plan_pb2, server_pb2  # noqa: F401
