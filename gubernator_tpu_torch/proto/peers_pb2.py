# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: peers.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import gubernator_pb2 as gubernator__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bpeers.proto\x12\rpb.gubernator\x1a\x10gubernator.proto\"E\n\x14GetPeerRateLimitsReq\x12-\n\x08requests\x18\x01 \x03(\x0b\x32\x1b.pb.gubernator.RateLimitReq\"J\n\x15GetPeerRateLimitsResp\x12\x31\n\x0brate_limits\x18\x01 \x03(\x0b\x32\x1c.pb.gubernator.RateLimitResp\"H\n\x14UpdatePeerGlobalsReq\x12\x30\n\x07globals\x18\x01 \x03(\x0b\x32\x1f.pb.gubernator.UpdatePeerGlobal\"z\n\x10UpdatePeerGlobal\x12\x0b\n\x03key\x18\x01 \x01(\t\x12,\n\x06status\x18\x02 \x01(\x0b\x32\x1c.pb.gubernator.RateLimitResp\x12+\n\talgorithm\x18\x03 \x01(\x0e\x32\x18.pb.gubernator.Algorithm\"\x17\n\x15UpdatePeerGlobalsResp\"L\n\x08LeaseReq\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12-\n\x08requests\x18\x02 \x03(\x0b\x32\x1b.pb.gubernator.RateLimitReq\"t\n\nLeaseGrant\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x11\n\tallowance\x18\x02 \x01(\x03\x12\x12\n\nexpires_at\x18\x03 \x01(\x03\x12\x12\n\nreset_time\x18\x04 \x01(\x03\x12\r\n\x05limit\x18\x05 \x01(\x03\x12\x0f\n\x07refusal\x18\x06 \x01(\t\"6\n\tLeaseResp\x12)\n\x06grants\x18\x01 \x03(\x0b\x32\x19.pb.gubernator.LeaseGrant\"]\n\rReconcileItem\x12,\n\x07request\x18\x01 \x01(\x0b\x32\x1b.pb.gubernator.RateLimitReq\x12\x0f\n\x07release\x18\x02 \x01(\x08\x12\r\n\x05renew\x18\x03 \x01(\x08\"N\n\x0cReconcileReq\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12+\n\x05items\x18\x02 \x03(\x0b\x32\x1c.pb.gubernator.ReconcileItem\":\n\rReconcileResp\x12)\n\x06grants\x18\x01 \x03(\x0b\x32\x19.pb.gubernator.LeaseGrant\"T\n\nHandoffReq\x12\x14\n\x0c\x66rom_address\x18\x01 \x01(\t\x12\r\n\x05\x65poch\x18\x02 \x01(\x03\x12\r\n\x05phase\x18\x03 \x01(\t\x12\x12\n\ntotal_rows\x18\x04 \x01(\x03\".\n\x0bHandoffResp\x12\x10\n\x08\x61\x63\x63\x65pted\x18\x01 \x01(\x08\x12\r\n\x05state\x18\x02 \x01(\t\"\xc3\x01\n\x0cMigratedRows\x12\x10\n\x08key_hash\x18\x01 \x03(\x03\x12\x0c\n\x04\x61lgo\x18\x02 \x03(\x05\x12\r\n\x05limit\x18\x03 \x03(\x03\x12\x10\n\x08\x64uration\x18\x04 \x03(\x03\x12\x11\n\tremaining\x18\x05 \x03(\x03\x12\x13\n\x0bremaining_f\x18\x06 \x03(\x01\x12\n\n\x02t0\x18\x07 \x03(\x03\x12\x0e\n\x06status\x18\x08 \x03(\x05\x12\r\n\x05\x62urst\x18\t \x03(\x03\x12\x11\n\texpire_at\x18\n \x03(\x03\x12\x0c\n\x04keys\x18\x0b \x03(\t\"k\n\nMigrateReq\x12\x14\n\x0c\x66rom_address\x18\x01 \x01(\t\x12\r\n\x05\x65poch\x18\x02 \x01(\x03\x12)\n\x04rows\x18\x03 \x01(\x0b\x32\x1b.pb.gubernator.MigratedRows\x12\r\n\x05\x66inal\x18\x04 \x01(\x08\"0\n\x0bMigrateResp\x12\x10\n\x08injected\x18\x01 \x01(\x03\x12\x0f\n\x07skipped\x18\x02 \x01(\x03\x32\xdd\x03\n\x07PeersV1\x12`\n\x11GetPeerRateLimits\x12#.pb.gubernator.GetPeerRateLimitsReq\x1a$.pb.gubernator.GetPeerRateLimitsResp\"\x00\x12`\n\x11UpdatePeerGlobals\x12#.pb.gubernator.UpdatePeerGlobalsReq\x1a$.pb.gubernator.UpdatePeerGlobalsResp\"\x00\x12<\n\x05Lease\x12\x17.pb.gubernator.LeaseReq\x1a\x18.pb.gubernator.LeaseResp\"\x00\x12H\n\tReconcile\x12\x1b.pb.gubernator.ReconcileReq\x1a\x1c.pb.gubernator.ReconcileResp\"\x00\x12\x42\n\x07Handoff\x12\x19.pb.gubernator.HandoffReq\x1a\x1a.pb.gubernator.HandoffResp\"\x00\x12\x42\n\x07Migrate\x12\x19.pb.gubernator.MigrateReq\x1a\x1a.pb.gubernator.MigrateResp\"\x00\x42\x03\x80\x01\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'peers_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\200\001\001'
  _GETPEERRATELIMITSREQ._serialized_start=48
  _GETPEERRATELIMITSREQ._serialized_end=117
  _GETPEERRATELIMITSRESP._serialized_start=119
  _GETPEERRATELIMITSRESP._serialized_end=193
  _UPDATEPEERGLOBALSREQ._serialized_start=195
  _UPDATEPEERGLOBALSREQ._serialized_end=267
  _UPDATEPEERGLOBAL._serialized_start=269
  _UPDATEPEERGLOBAL._serialized_end=391
  _UPDATEPEERGLOBALSRESP._serialized_start=393
  _UPDATEPEERGLOBALSRESP._serialized_end=416
  _LEASEREQ._serialized_start=418
  _LEASEREQ._serialized_end=494
  _LEASEGRANT._serialized_start=496
  _LEASEGRANT._serialized_end=612
  _LEASERESP._serialized_start=614
  _LEASERESP._serialized_end=668
  _RECONCILEITEM._serialized_start=670
  _RECONCILEITEM._serialized_end=763
  _RECONCILEREQ._serialized_start=765
  _RECONCILEREQ._serialized_end=843
  _RECONCILERESP._serialized_start=845
  _RECONCILERESP._serialized_end=903
  _HANDOFFREQ._serialized_start=905
  _HANDOFFREQ._serialized_end=989
  _HANDOFFRESP._serialized_start=991
  _HANDOFFRESP._serialized_end=1037
  _MIGRATEDROWS._serialized_start=1040
  _MIGRATEDROWS._serialized_end=1235
  _MIGRATEREQ._serialized_start=1237
  _MIGRATEREQ._serialized_end=1344
  _MIGRATERESP._serialized_start=1346
  _MIGRATERESP._serialized_end=1394
  _PEERSV1._serialized_start=1397
  _PEERSV1._serialized_end=1874
# @@protoc_insertion_point(module_scope)
