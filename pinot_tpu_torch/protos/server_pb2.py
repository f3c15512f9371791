# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: server.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cserver.proto\x12\tpinot.tpu\"\x18\n\x05\x46rame\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\x32i\n\x06Server\x12.\n\x06Submit\x12\x10.pinot.tpu.Frame\x1a\x10.pinot.tpu.Frame0\x01\x12/\n\x07Mailbox\x12\x10.pinot.tpu.Frame\x1a\x10.pinot.tpu.Frame(\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'server_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FRAME._serialized_start=27
  _FRAME._serialized_end=51
  _SERVER._serialized_start=53
  _SERVER._serialized_end=158
# @@protoc_insertion_point(module_scope)
