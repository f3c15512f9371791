# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: plan.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nplan.proto\x12\tpinot.tpu\",\n\rMailboxTarget\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x0e\n\x06worker\x18\x02 \x01(\x05\"\xa3\x01\n\x0c\x45xchangeSpec\x12*\n\x04type\x18\x01 \x01(\x0e\x32\x1c.pinot.tpu.ExchangeSpec.Type\x12\x0c\n\x04keys\x18\x02 \x03(\t\x12\r\n\x05stage\x18\x03 \x01(\x05\x12)\n\x07targets\x18\x04 \x03(\x0b\x32\x18.pinot.tpu.MailboxTarget\"\x1f\n\x04Type\x12\x08\n\x04HASH\x10\x00\x12\r\n\tBROADCAST\x10\x01\"R\n\tLeafStage\x12\x0b\n\x03sql\x18\x01 \x01(\t\x12\r\n\x05\x61lias\x18\x02 \x01(\t\x12)\n\x08\x65xchange\x18\x03 \x01(\x0b\x32\x17.pinot.tpu.ExchangeSpec\"\xbe\x01\n\tJoinStage\x12\x0e\n\x06worker\x18\x01 \x01(\x05\x12\x12\n\nleft_stage\x18\x02 \x01(\x05\x12\x13\n\x0bright_stage\x18\x03 \x01(\x05\x12\x11\n\tleft_keys\x18\x04 \x03(\t\x12\x12\n\nright_keys\x18\x05 \x03(\t\x12\x0b\n\x03how\x18\x06 \x01(\t\x12\x16\n\x0en_left_senders\x18\x07 \x01(\x05\x12\x17\n\x0fn_right_senders\x18\x08 \x01(\x05\x12\x13\n\x0btimeout_sec\x18\t \x01(\x01\"q\n\tStagePlan\x12\x10\n\x08query_id\x18\x01 \x01(\t\x12$\n\x04leaf\x18\x02 \x01(\x0b\x32\x14.pinot.tpu.LeafStageH\x00\x12$\n\x04join\x18\x03 \x01(\x0b\x32\x14.pinot.tpu.JoinStageH\x00\x42\x06\n\x04node\"M\n\rMailboxHeader\x12\x10\n\x08query_id\x18\x01 \x01(\t\x12\r\n\x05stage\x18\x02 \x01(\x05\x12\x0e\n\x06worker\x18\x03 \x01(\x05\x12\x0b\n\x03\x65os\x18\x04 \x01(\x08\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'plan_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MAILBOXTARGET._serialized_start=25
  _MAILBOXTARGET._serialized_end=69
  _EXCHANGESPEC._serialized_start=72
  _EXCHANGESPEC._serialized_end=235
  _EXCHANGESPEC_TYPE._serialized_start=204
  _EXCHANGESPEC_TYPE._serialized_end=235
  _LEAFSTAGE._serialized_start=237
  _LEAFSTAGE._serialized_end=319
  _JOINSTAGE._serialized_start=322
  _JOINSTAGE._serialized_end=512
  _STAGEPLAN._serialized_start=514
  _STAGEPLAN._serialized_end=627
  _MAILBOXHEADER._serialized_start=629
  _MAILBOXHEADER._serialized_end=706
# @@protoc_insertion_point(module_scope)
