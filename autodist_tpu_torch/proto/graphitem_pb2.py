# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: autodist_tpu/proto/graphitem.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\"autodist_tpu/proto/graphitem.proto\x12\x0c\x61utodist_tpu\"x\n\x0cVariableItem\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05shape\x18\x02 \x03(\x03\x12\r\n\x05\x64type\x18\x03 \x01(\t\x12\x11\n\ttrainable\x18\x04 \x01(\x08\x12\x15\n\rsparse_access\x18\x05 \x01(\x08\x12\x12\n\nsize_bytes\x18\x06 \x01(\x03\"=\n\x0fTensorSpecProto\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05shape\x18\x02 \x03(\x03\x12\r\n\x05\x64type\x18\x03 \x01(\t\"\x99\x01\n\tGraphItem\x12-\n\tvariables\x18\x01 \x03(\x0b\x32\x1a.autodist_tpu.VariableItem\x12\x31\n\nbatch_spec\x18\x02 \x03(\x0b\x32\x1d.autodist_tpu.TensorSpecProto\x12\x16\n\x0eoptimizer_name\x18\x03 \x01(\t\x12\x12\n\njaxpr_text\x18\x04 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'autodist_tpu.proto.graphitem_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VARIABLEITEM._serialized_start=52
  _VARIABLEITEM._serialized_end=172
  _TENSORSPECPROTO._serialized_start=174
  _TENSORSPECPROTO._serialized_end=235
  _GRAPHITEM._serialized_start=238
  _GRAPHITEM._serialized_end=391
# @@protoc_insertion_point(module_scope)
