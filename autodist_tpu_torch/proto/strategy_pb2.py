# -*- coding: utf-8 -*-
# Generated by scripts/regen_strategy_pb2.py (no protoc in the toolchain).
# source: autodist_tpu/proto/strategy.proto  DO NOT EDIT BY HAND.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n!autodist_tpu/proto/strategy.proto\x12\x0cautodist_tpu"\x81\x01\n\x0ePSSynchronizer\x12\x1d\n\x15reduction_destination\x18\x01 \x01(\t\x12\x19\n\x11local_replication\x18\x02 \x01(\x08\x12\x0c\n\x04sync\x18\x03 \x01(\x08\x12\x11\n\tstaleness\x18\x04 \x01(\x05\x12\x14\n\x0cgspmd_update\x18\x05 \x01(\x08"\xdb\x02\n\x15AllReduceSynchronizer\x126\n\x04spec\x18\x01 \x01(\x0e2(.autodist_tpu.AllReduceSynchronizer.Spec\x12B\n\ncompressor\x18\x02 \x01(\x0e2..autodist_tpu.AllReduceSynchronizer.Compressor\x12\r\n\x05group\x18\x03 \x01(\x05""\n\x04Spec\x12\x08\n\x04AUTO\x10\x00\x12\x07\n\x03ICI\x10\x01\x12\x07\n\x03DCN\x10\x02"\x92\x01\n\nCompressor\x12\x12\n\x0eNoneCompressor\x10\x00\x12\x15\n\x11HorovodCompressor\x10\x01\x12\x17\n\x13HorovodCompressorEF\x10\x02\x12\x16\n\x12PowerSGDCompressor\x10\x03\x12\x12\n\x0eInt8Compressor\x10\x04\x12\x14\n\x10Int8CompressorEF\x10\x05"\xf3\x01\n\nNodeConfig\x12\x10\n\x08var_name\x18\x01 \x01(\t\x127\n\x0fps_synchronizer\x18\x02 \x01(\x0b2\x1c.autodist_tpu.PSSynchronizerH\x00\x12F\n\x17all_reduce_synchronizer\x18\x03 \x01(\x0b2#.autodist_tpu.AllReduceSynchronizerH\x00\x12\x13\n\x0bpartitioner\x18\x04 \x01(\t\x12-\n\x0bpart_config\x18\x05 \x03(\x0b2\x18.autodist_tpu.NodeConfigB\x0e\n\x0csynchronizer"\xb3\x02\n\x0bGraphConfig\x12\x10\n\x08replicas\x18\x01 \x03(\t\x12:\n\tmesh_axes\x18\x02 \x03(\x0b2\'.autodist_tpu.GraphConfig.MeshAxesEntry\x12\x10\n\x08seq_attn\x18\x03 \x01(\t\x12\x1d\n\x15pipeline_microbatches\x18\x04 \x01(\x05\x12@\n\x0cop_shardings\x18\x05 \x03(\x0b2*.autodist_tpu.GraphConfig.OpShardingsEntry\x1a/\n\rMeshAxesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x028\x01\x1a2\n\x10OpShardingsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"\x84\x01\n\x08Strategy\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04path\x18\x02 \x01(\t\x12-\n\x0bnode_config\x18\x03 \x03(\x0b2\x18.autodist_tpu.NodeConfig\x12/\n\x0cgraph_config\x18\x04 \x01(\x0b2\x19.autodist_tpu.GraphConfigb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'autodist_tpu.proto.strategy_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:
  DESCRIPTOR._options = None
  for _name, _msg in list(globals().items()):
    _nested = getattr(getattr(_msg, 'DESCRIPTOR', None), 'nested_types', ())
    for _nt in _nested:
      if _nt.GetOptions().map_entry:
        _nt._options = None
        _nt._serialized_options = b'8\001'
# @@protoc_insertion_point(module_scope)
