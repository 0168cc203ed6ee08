# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dsg_map.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rdsg_map.proto\x12\x03\x64sg\",\n\x03Map\x12%\n\x0cmap_features\x18\x01 \x03(\x0b\x32\x0f.dsg.MapFeature\"+\n\x08MapPoint\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\x12\t\n\x01z\x18\x03 \x01(\x01\"\x93\x01\n\x0f\x42oundarySegment\x12\x18\n\x10lane_start_index\x18\x01 \x01(\x05\x12\x16\n\x0elane_end_index\x18\x02 \x01(\x05\x12\x1b\n\x13\x62oundary_feature_id\x18\x03 \x01(\x03\x12\x31\n\rboundary_type\x18\x04 \x01(\x0e\x32\x1a.dsg.RoadLine.RoadLineType\"\xb8\x01\n\x0cLaneNeighbor\x12\x12\n\nfeature_id\x18\x01 \x01(\x03\x12\x18\n\x10self_start_index\x18\x02 \x01(\x05\x12\x16\n\x0eself_end_index\x18\x03 \x01(\x05\x12\x1c\n\x14neighbor_start_index\x18\x04 \x01(\x05\x12\x1a\n\x12neighbor_end_index\x18\x05 \x01(\x05\x12(\n\nboundaries\x18\x06 \x03(\x0b\x32\x14.dsg.BoundarySegment\"\xcb\x03\n\nLaneCenter\x12\x17\n\x0fspeed_limit_mph\x18\x01 \x01(\x01\x12&\n\x04type\x18\x02 \x01(\x0e\x32\x18.dsg.LaneCenter.LaneType\x12\x15\n\rinterpolating\x18\x03 \x01(\x08\x12\x1f\n\x08polyline\x18\x08 \x03(\x0b\x32\r.dsg.MapPoint\x12\x17\n\x0b\x65ntry_lanes\x18\t \x03(\x03\x42\x02\x10\x01\x12\x16\n\nexit_lanes\x18\n \x03(\x03\x42\x02\x10\x01\x12)\n\x0eleft_neighbors\x18\x0b \x03(\x0b\x32\x11.dsg.LaneNeighbor\x12*\n\x0fright_neighbors\x18\x0c \x03(\x0b\x32\x11.dsg.LaneNeighbor\x12-\n\x0fleft_boundaries\x18\r \x03(\x0b\x32\x14.dsg.BoundarySegment\x12.\n\x10right_boundaries\x18\x0e \x03(\x0b\x32\x14.dsg.BoundarySegment\"]\n\x08LaneType\x12\x12\n\x0eTYPE_UNDEFINED\x10\x00\x12\x10\n\x0cTYPE_FREEWAY\x10\x01\x12\x17\n\x13TYPE_SURFACE_STREET\x10\x02\x12\x12\n\x0eTYPE_BIKE_LANE\x10\x03\"\xaf\x01\n\x08RoadEdge\x12(\n\x04type\x18\x01 \x01(\x0e\x32\x1a.dsg.RoadEdge.RoadEdgeType\x12\x1f\n\x08polyline\x18\x02 \x03(\x0b\x32\r.dsg.MapPoint\"X\n\x0cRoadEdgeType\x12\x10\n\x0cTYPE_UNKNOWN\x10\x00\x12\x1b\n\x17TYPE_ROAD_EDGE_BOUNDARY\x10\x01\x12\x19\n\x15TYPE_ROAD_EDGE_MEDIAN\x10\x02\"\xea\x02\n\x08RoadLine\x12(\n\x04type\x18\x01 \x01(\x0e\x32\x1a.dsg.RoadLine.RoadLineType\x12\x1f\n\x08polyline\x18\x02 \x03(\x0b\x32\r.dsg.MapPoint\"\x92\x02\n\x0cRoadLineType\x12\x10\n\x0cTYPE_UNKNOWN\x10\x00\x12\x1c\n\x18TYPE_BROKEN_SINGLE_WHITE\x10\x01\x12\x1b\n\x17TYPE_SOLID_SINGLE_WHITE\x10\x02\x12\x1b\n\x17TYPE_SOLID_DOUBLE_WHITE\x10\x03\x12\x1d\n\x19TYPE_BROKEN_SINGLE_YELLOW\x10\x04\x12\x1d\n\x19TYPE_BROKEN_DOUBLE_YELLOW\x10\x05\x12\x1c\n\x18TYPE_SOLID_SINGLE_YELLOW\x10\x06\x12\x1c\n\x18TYPE_SOLID_DOUBLE_YELLOW\x10\x07\x12\x1e\n\x1aTYPE_PASSING_DOUBLE_YELLOW\x10\x08\"9\n\x08StopSign\x12\x0c\n\x04lane\x18\x01 \x03(\x03\x12\x1f\n\x08position\x18\x02 \x01(\x0b\x32\r.dsg.MapPoint\"+\n\tCrosswalk\x12\x1e\n\x07polygon\x18\x01 \x03(\x0b\x32\r.dsg.MapPoint\"+\n\tSpeedBump\x12\x1e\n\x07polygon\x18\x01 \x03(\x0b\x32\r.dsg.MapPoint\"*\n\x08\x44riveway\x12\x1e\n\x07polygon\x18\x01 \x03(\x0b\x32\r.dsg.MapPoint\"\xa3\x02\n\nMapFeature\x12\n\n\x02id\x18\x01 \x01(\x03\x12\x1f\n\x04lane\x18\x03 \x01(\x0b\x32\x0f.dsg.LaneCenterH\x00\x12\"\n\troad_line\x18\x04 \x01(\x0b\x32\r.dsg.RoadLineH\x00\x12\"\n\troad_edge\x18\x05 \x01(\x0b\x32\r.dsg.RoadEdgeH\x00\x12\"\n\tstop_sign\x18\x07 \x01(\x0b\x32\r.dsg.StopSignH\x00\x12#\n\tcrosswalk\x18\x08 \x01(\x0b\x32\x0e.dsg.CrosswalkH\x00\x12$\n\nspeed_bump\x18\t \x01(\x0b\x32\x0e.dsg.SpeedBumpH\x00\x12!\n\x08\x64riveway\x18\x14 \x01(\x0b\x32\r.dsg.DrivewayH\x00\x42\x0e\n\x0c\x66\x65\x61ture_data\"\xee\x02\n\x16TrafficSignalLaneState\x12\x0c\n\x04lane\x18\x01 \x01(\x03\x12\x30\n\x05state\x18\x02 \x01(\x0e\x32!.dsg.TrafficSignalLaneState.State\x12!\n\nstop_point\x18\x03 \x01(\x0b\x32\r.dsg.MapPoint\"\xf0\x01\n\x05State\x12\x16\n\x12LANE_STATE_UNKNOWN\x10\x00\x12\x19\n\x15LANE_STATE_ARROW_STOP\x10\x01\x12\x1c\n\x18LANE_STATE_ARROW_CAUTION\x10\x02\x12\x17\n\x13LANE_STATE_ARROW_GO\x10\x03\x12\x13\n\x0fLANE_STATE_STOP\x10\x04\x12\x16\n\x12LANE_STATE_CAUTION\x10\x05\x12\x11\n\rLANE_STATE_GO\x10\x06\x12\x1c\n\x18LANE_STATE_FLASHING_STOP\x10\x07\x12\x1f\n\x1bLANE_STATE_FLASHING_CAUTION\x10\x08\"[\n\x0c\x44ynamicState\x12\x19\n\x11timestamp_seconds\x18\x01 \x01(\x01\x12\x30\n\x0blane_states\x18\x02 \x03(\x0b\x32\x1b.dsg.TrafficSignalLaneState')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'drivescenegen_torch.data.protos.dsg_map_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _LANECENTER.fields_by_name['entry_lanes']._options = None
  _LANECENTER.fields_by_name['entry_lanes']._serialized_options = b'\020\001'
  _LANECENTER.fields_by_name['exit_lanes']._options = None
  _LANECENTER.fields_by_name['exit_lanes']._serialized_options = b'\020\001'
  _MAP._serialized_start=22
  _MAP._serialized_end=66
  _MAPPOINT._serialized_start=68
  _MAPPOINT._serialized_end=111
  _BOUNDARYSEGMENT._serialized_start=114
  _BOUNDARYSEGMENT._serialized_end=261
  _LANENEIGHBOR._serialized_start=264
  _LANENEIGHBOR._serialized_end=448
  _LANECENTER._serialized_start=451
  _LANECENTER._serialized_end=910
  _LANECENTER_LANETYPE._serialized_start=817
  _LANECENTER_LANETYPE._serialized_end=910
  _ROADEDGE._serialized_start=913
  _ROADEDGE._serialized_end=1088
  _ROADEDGE_ROADEDGETYPE._serialized_start=1000
  _ROADEDGE_ROADEDGETYPE._serialized_end=1088
  _ROADLINE._serialized_start=1091
  _ROADLINE._serialized_end=1453
  _ROADLINE_ROADLINETYPE._serialized_start=1179
  _ROADLINE_ROADLINETYPE._serialized_end=1453
  _STOPSIGN._serialized_start=1455
  _STOPSIGN._serialized_end=1512
  _CROSSWALK._serialized_start=1514
  _CROSSWALK._serialized_end=1557
  _SPEEDBUMP._serialized_start=1559
  _SPEEDBUMP._serialized_end=1602
  _DRIVEWAY._serialized_start=1604
  _DRIVEWAY._serialized_end=1646
  _MAPFEATURE._serialized_start=1649
  _MAPFEATURE._serialized_end=1940
  _TRAFFICSIGNALLANESTATE._serialized_start=1943
  _TRAFFICSIGNALLANESTATE._serialized_end=2309
  _TRAFFICSIGNALLANESTATE_STATE._serialized_start=2069
  _TRAFFICSIGNALLANESTATE_STATE._serialized_end=2309
  _DYNAMICSTATE._serialized_start=2311
  _DYNAMICSTATE._serialized_end=2402
# @@protoc_insertion_point(module_scope)
