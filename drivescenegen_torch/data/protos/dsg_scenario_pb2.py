# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dsg_scenario.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import dsg_map_pb2 as dsg__map__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12\x64sg_scenario.proto\x12\x03\x64sg\x1a\rdsg_map.proto\"\xba\x01\n\x0bObjectState\x12\x10\n\x08\x63\x65nter_x\x18\x02 \x01(\x01\x12\x10\n\x08\x63\x65nter_y\x18\x03 \x01(\x01\x12\x10\n\x08\x63\x65nter_z\x18\x04 \x01(\x01\x12\x0e\n\x06length\x18\x05 \x01(\x02\x12\r\n\x05width\x18\x06 \x01(\x02\x12\x0e\n\x06height\x18\x07 \x01(\x02\x12\x0f\n\x07heading\x18\x08 \x01(\x02\x12\x12\n\nvelocity_x\x18\t \x01(\x02\x12\x12\n\nvelocity_y\x18\n \x01(\x02\x12\r\n\x05valid\x18\x0b \x01(\x08\"\xc8\x01\n\x05Track\x12\n\n\x02id\x18\x01 \x01(\x05\x12*\n\x0bobject_type\x18\x02 \x01(\x0e\x32\x15.dsg.Track.ObjectType\x12 \n\x06states\x18\x03 \x03(\x0b\x32\x10.dsg.ObjectState\"e\n\nObjectType\x12\x0e\n\nTYPE_UNSET\x10\x00\x12\x10\n\x0cTYPE_VEHICLE\x10\x01\x12\x13\n\x0fTYPE_PEDESTRIAN\x10\x02\x12\x10\n\x0cTYPE_CYCLIST\x10\x03\x12\x0e\n\nTYPE_OTHER\x10\x04\"C\n\x0f\x44ynamicMapState\x12\x30\n\x0blane_states\x18\x01 \x03(\x0b\x32\x1b.dsg.TrafficSignalLaneState\"\x9d\x01\n\x12RequiredPrediction\x12\x13\n\x0btrack_index\x18\x01 \x01(\x05\x12;\n\ndifficulty\x18\x02 \x01(\x0e\x32\'.dsg.RequiredPrediction.DifficultyLevel\"5\n\x0f\x44ifficultyLevel\x12\x08\n\x04NONE\x10\x00\x12\x0b\n\x07LEVEL_1\x10\x01\x12\x0b\n\x07LEVEL_2\x10\x02\"\xbc\x02\n\x08Scenario\x12\x13\n\x0bscenario_id\x18\x05 \x01(\t\x12\x1a\n\x12timestamps_seconds\x18\x01 \x03(\x01\x12\x1a\n\x12\x63urrent_time_index\x18\n \x01(\x05\x12\x1a\n\x06tracks\x18\x02 \x03(\x0b\x32\n.dsg.Track\x12\x30\n\x12\x64ynamic_map_states\x18\x07 \x03(\x0b\x32\x14.dsg.DynamicMapState\x12%\n\x0cmap_features\x18\x08 \x03(\x0b\x32\x0f.dsg.MapFeature\x12\x17\n\x0fsdc_track_index\x18\x06 \x01(\x05\x12\x1b\n\x13objects_of_interest\x18\x04 \x03(\x05\x12\x32\n\x11tracks_to_predict\x18\x0b \x03(\x0b\x32\x17.dsg.RequiredPredictionJ\x04\x08\t\x10\n')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'drivescenegen_torch.data.protos.dsg_scenario_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _OBJECTSTATE._serialized_start=43
  _OBJECTSTATE._serialized_end=229
  _TRACK._serialized_start=232
  _TRACK._serialized_end=432
  _TRACK_OBJECTTYPE._serialized_start=331
  _TRACK_OBJECTTYPE._serialized_end=432
  _DYNAMICMAPSTATE._serialized_start=434
  _DYNAMICMAPSTATE._serialized_end=501
  _REQUIREDPREDICTION._serialized_start=504
  _REQUIREDPREDICTION._serialized_end=661
  _REQUIREDPREDICTION_DIFFICULTYLEVEL._serialized_start=608
  _REQUIREDPREDICTION_DIFFICULTYLEVEL._serialized_end=661
  _SCENARIO._serialized_start=664
  _SCENARIO._serialized_end=980
# @@protoc_insertion_point(module_scope)
