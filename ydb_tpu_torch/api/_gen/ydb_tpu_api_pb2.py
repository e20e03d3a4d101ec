# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ydb_tpu_api.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x11ydb_tpu_api.proto\x12\x07ydb_tpu\"6\n\x13\x45xecuteQueryRequest\x12\x12\n\nsession_id\x18\x01 \x01(\t\x12\x0b\n\x03sql\x18\x02 \x01(\t\"\xc7\x01\n\x14\x45xecuteQueryResponse\x12\x34\n\x06status\x18\x01 \x01(\x0e\x32$.ydb_tpu.ExecuteQueryResponse.Status\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12\x11\n\tarrow_ipc\x18\x03 \x01(\x0c\x12\x0f\n\x07tx_step\x18\x04 \x01(\x03\x12\x11\n\tcommitted\x18\x05 \x01(\x08\x12\x11\n\tplan_text\x18\x06 \x01(\t\" \n\x06Status\x12\x0b\n\x07SUCCESS\x10\x00\x12\t\n\x05\x45RROR\x10\x01\"\x16\n\x14\x43reateSessionRequest\"+\n\x15\x43reateSessionResponse\x12\x12\n\nsession_id\x18\x01 \x01(\t\"*\n\x14\x44\x65leteSessionRequest\x12\x12\n\nsession_id\x18\x01 \x01(\t\"\x17\n\x15\x44\x65leteSessionResponse\"$\n\x14ListDirectoryRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\")\n\x0bSchemeEntry\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0c\n\x04kind\x18\x02 \x01(\t\"N\n\x15ListDirectoryResponse\x12&\n\x08\x63hildren\x18\x01 \x03(\x0b\x32\x14.ydb_tpu.SchemeEntry\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"$\n\x14\x44\x65scribeTableRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\":\n\nColumnMeta\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x10\n\x08nullable\x18\x03 \x01(\x08\"\xa6\x01\n\x15\x44\x65scribeTableResponse\x12\x0c\n\x04path\x18\x01 \x01(\t\x12$\n\x07\x63olumns\x18\x02 \x03(\x0b\x32\x13.ydb_tpu.ColumnMeta\x12\x13\n\x0bprimary_key\x18\x03 \x03(\t\x12\x0e\n\x06shards\x18\x04 \x01(\x05\x12\r\n\x05store\x18\x05 \x01(\t\x12\x16\n\x0eschema_version\x18\x06 \x01(\x05\x12\r\n\x05\x65rror\x18\x07 \x01(\t\"^\n\x11TopicWriteRequest\x12\r\n\x05topic\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\x12\x10\n\x08producer\x18\x04 \x01(\t\x12\r\n\x05seqno\x18\x05 \x01(\x03\"F\n\x12TopicWriteResponse\x12\x11\n\tpartition\x18\x01 \x01(\x05\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"B\n\x10TopicReadRequest\x12\r\n\x05topic\x18\x01 \x01(\t\x12\x10\n\x08\x63onsumer\x18\x02 \x01(\t\x12\r\n\x05limit\x18\x03 \x01(\x05\"?\n\x0cTopicMessage\x12\x11\n\tpartition\x18\x01 \x01(\x05\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\"K\n\x11TopicReadResponse\x12\'\n\x08messages\x18\x01 \x03(\x0b\x32\x15.ydb_tpu.TopicMessage\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"u\n\x11StreamReadRequest\x12\r\n\x05topic\x18\x01 \x01(\t\x12\x10\n\x08\x63onsumer\x18\x02 \x01(\t\x12\x11\n\tmax_batch\x18\x03 \x01(\x05\x12\x13\n\x0b\x61uto_commit\x18\x04 \x01(\x08\x12\x17\n\x0fidle_timeout_ms\x18\x05 \x01(\x03\"\\\n\x0fStreamWriteItem\x12\r\n\x05topic\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\x12\x10\n\x08producer\x18\x04 \x01(\t\x12\r\n\x05seqno\x18\x05 \x01(\x03\"B\n\x0eStreamWriteAck\x12\x11\n\tpartition\x18\x01 \x01(\x05\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"X\n\x12TopicCommitRequest\x12\r\n\x05topic\x18\x01 \x01(\t\x12\x10\n\x08\x63onsumer\x18\x02 \x01(\t\x12\x11\n\tpartition\x18\x03 \x01(\x05\x12\x0e\n\x06offset\x18\x04 \x01(\x03\"$\n\x13TopicCommitResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\">\n\rExportRequest\x12\r\n\x05table\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x10\n\x08\x61sync_op\x18\x03 \x01(\x08\"d\n\x0e\x45xportResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0c\n\x04rows\x18\x02 \x01(\x03\x12\r\n\x05parts\x18\x03 \x01(\x05\x12\x10\n\x08snapshot\x18\x04 \x01(\x03\x12\x14\n\x0coperation_id\x18\x05 \x01(\t\"<\n\rImportRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05table\x18\x02 \x01(\t\x12\x0e\n\x06shards\x18\x03 \x01(\x05\"-\n\x0eImportResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0c\n\x04rows\x18\x02 \x01(\x03\"\x14\n\x12ListBackupsRequest\":\n\nBackupInfo\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04rows\x18\x02 \x01(\x03\x12\x10\n\x08snapshot\x18\x03 \x01(\x03\";\n\x13ListBackupsResponse\x12$\n\x07\x62\x61\x63kups\x18\x01 \x03(\x0b\x32\x13.ydb_tpu.BackupInfo\"B\n\x15\x43reateResourceRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0c\n\x04rate\x18\x02 \x01(\x01\x12\r\n\x05\x62urst\x18\x03 \x01(\x01\"\'\n\x16\x43reateResourceResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"6\n\x16\x41\x63quireResourceRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0e\n\x06\x61mount\x18\x02 \x01(\x01\"Q\n\x17\x41\x63quireResourceResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x10\n\x08\x61\x63quired\x18\x02 \x01(\x08\x12\x15\n\rretry_after_s\x18\x03 \x01(\x01\"\'\n\x17\x44\x65scribeResourceRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\"V\n\x18\x44\x65scribeResourceResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0c\n\x04rate\x18\x02 \x01(\x01\x12\r\n\x05\x62urst\x18\x03 \x01(\x01\x12\x0e\n\x06tokens\x18\x04 \x01(\x01\"&\n\x14\x45xecuteScriptRequest\x12\x0e\n\x06script\x18\x01 \x01(\t\"A\n\x15ScriptStatementResult\x12\x0b\n\x03sql\x18\x01 \x01(\t\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12\x0c\n\x04rows\x18\x03 \x01(\x03\"s\n\x15\x45xecuteScriptResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x32\n\nstatements\x18\x02 \x03(\x0b\x32\x1e.ydb_tpu.ScriptStatementResult\x12\x17\n\x0flast_result_ipc\x18\x03 \x01(\x0c\"!\n\x13GetOperationRequest\x12\n\n\x02id\x18\x01 \x01(\t\"W\n\x0fOperationStatus\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05ready\x18\x02 \x01(\x08\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x0c\n\x04rows\x18\x04 \x01(\x03\x12\x0c\n\x04kind\x18\x05 \x01(\t\"\x17\n\x15ListOperationsRequest\"F\n\x16ListOperationsResponse\x12,\n\noperations\x18\x01 \x03(\x0b\x32\x18.ydb_tpu.OperationStatus\"$\n\x16\x43\x61ncelOperationRequest\x12\n\n\x02id\x18\x01 \x01(\t\"\x14\n\x12HealthCheckRequest\"C\n\x0bHealthIssue\x12\x0f\n\x07message\x18\x01 \x01(\t\x12\x11\n\tcomponent\x18\x02 \x01(\t\x12\x10\n\x08severity\x18\x03 \x01(\t\"K\n\x13HealthCheckResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12$\n\x06issues\x18\x02 \x03(\x0b\x32\x14.ydb_tpu.HealthIssue\"<\n\x13\x43oordSessionRequest\x12\x11\n\ttimeout_s\x18\x01 \x01(\x01\x12\x12\n\nsession_id\x18\x02 \x01(\x03\"9\n\x14\x43oordSessionResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x12\n\nsession_id\x18\x02 \x01(\x03\"j\n\x15\x43oordSemaphoreRequest\x12\x12\n\nsession_id\x18\x01 \x01(\x03\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\r\n\x05limit\x18\x03 \x01(\x03\x12\r\n\x05\x63ount\x18\x04 \x01(\x03\x12\x11\n\ttimeout_s\x18\x05 \x01(\x01\"x\n\x16\x43oordSemaphoreResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x10\n\x08\x61\x63quired\x18\x02 \x01(\x08\x12\r\n\x05\x63ount\x18\x03 \x01(\x03\x12\r\n\x05limit\x18\x04 \x01(\x03\x12\x0f\n\x07waiters\x18\x05 \x03(\x03\x12\x0e\n\x06owners\x18\x06 \x03(\x03\"\x12\n\x10GetConfigRequest\"A\n\x11GetConfigResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0c\n\x04yaml\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\x03\"8\n\x10SetConfigRequest\x12\x0c\n\x04yaml\x18\x01 \x01(\t\x12\x16\n\x0e\x65xpect_version\x18\x02 \x01(\x03\"3\n\x11SetConfigResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x03\"\x0f\n\rWhoAmIRequest\"5\n\x0eWhoAmIResponse\x12\x0c\n\x04user\x18\x01 \x01(\t\x12\x15\n\rauthenticated\x18\x02 \x01(\x08\"?\n\x0fTableColumnSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x10\n\x08not_null\x18\x03 \x01(\x08\"\x81\x01\n\x12\x43reateTableRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12)\n\x07\x63olumns\x18\x02 \x03(\x0b\x32\x18.ydb_tpu.TableColumnSpec\x12\x13\n\x0bprimary_key\x18\x03 \x03(\t\x12\r\n\x05store\x18\x04 \x01(\t\x12\x0e\n\x06shards\x18\x05 \x01(\x05\"$\n\x13\x43reateTableResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\" \n\x10\x44ropTableRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\"\"\n\x11\x44ropTableResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"Z\n\x1b\x41lterTableAddColumnsRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12-\n\x0b\x61\x64\x64_columns\x18\x02 \x03(\x0b\x32\x18.ydb_tpu.TableColumnSpec\";\n\x12\x41lterTableResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x16\n\x0eschema_version\x18\x02 \x01(\x05\",\n\x10\x43opyTableRequest\x12\x0b\n\x03src\x18\x01 \x01(\t\x12\x0b\n\x03\x64st\x18\x02 \x01(\t\"0\n\x11\x43opyTableResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0c\n\x04rows\x18\x02 \x01(\x03\"9\n\tTxControl\x12\r\n\x05\x62\x65gin\x18\x01 \x01(\x08\x12\x0e\n\x06\x63ommit\x18\x02 \x01(\x08\x12\r\n\x05tx_id\x18\x03 \x01(\t\"Z\n\x17\x45xecuteDataQueryRequest\x12\x12\n\nsession_id\x18\x01 \x01(\t\x12\x0b\n\x03sql\x18\x02 \x01(\t\x12\x1e\n\x02tx\x18\x03 \x01(\x0b\x32\x12.ydb_tpu.TxControl\"o\n\x18\x45xecuteDataQueryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x11\n\tarrow_ipc\x18\x02 \x01(\x0c\x12\r\n\x05tx_id\x18\x03 \x01(\t\x12\x0f\n\x07tx_step\x18\x04 \x01(\x03\x12\x11\n\tcommitted\x18\x05 \x01(\x08\"5\n\x11\x42ulkUpsertRequest\x12\r\n\x05table\x18\x01 \x01(\t\x12\x11\n\tarrow_ipc\x18\x02 \x01(\x0c\"B\n\x12\x42ulkUpsertResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0c\n\x04rows\x18\x02 \x01(\x03\x12\x0f\n\x07tx_step\x18\x03 \x01(\x03\"E\n\x10ReadTableRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0f\n\x07\x63olumns\x18\x02 \x03(\t\x12\x12\n\nbatch_rows\x18\x03 \x01(\x05\"2\n\x0eReadTableBatch\x12\x11\n\tarrow_ipc\x18\x01 \x01(\x0c\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\"\n\x13\x45xplainQueryRequest\x12\x0b\n\x03sql\x18\x01 \x01(\t\"8\n\x14\x45xplainQueryResponse\x12\x11\n\tplan_text\x18\x01 \x01(\t\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x1f\n\x0fKvVolumeRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\"!\n\x10KvVolumeResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"<\n\x0eKvWriteRequest\x12\x0e\n\x06volume\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\x0c\" \n\x0fKvWriteResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\",\n\rKvReadRequest\x12\x0e\n\x06volume\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\"=\n\x0eKvReadResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\r\n\x05\x66ound\x18\x02 \x01(\x08\x12\r\n\x05value\x18\x03 \x01(\x0c\"M\n\x12KvListRangeRequest\x12\x0e\n\x06volume\x18\x01 \x01(\t\x12\x0c\n\x04\x66rom\x18\x02 \x01(\t\x12\n\n\x02to\x18\x03 \x01(\t\x12\r\n\x05limit\x18\x04 \x01(\x05\"$\n\x06KvPair\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c\"D\n\x13KvListRangeResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x1e\n\x05pairs\x18\x02 \x03(\x0b\x32\x0f.ydb_tpu.KvPair\"@\n\x14KvDeleteRangeRequest\x12\x0e\n\x06volume\x18\x01 \x01(\t\x12\x0c\n\x04\x66rom\x18\x02 \x01(\t\x12\n\n\x02to\x18\x03 \x01(\t\"7\n\x15KvDeleteRangeResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0f\n\x07\x64\x65leted\x18\x02 \x01(\x03\"C\n\x0fKvRenameRequest\x12\x0e\n\x06volume\x18\x01 \x01(\t\x12\x0f\n\x07old_key\x18\x02 \x01(\t\x12\x0f\n\x07new_key\x18\x03 \x01(\t\"2\n\x10KvRenameResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0f\n\x07renamed\x18\x02 \x01(\x08\" \n\x1eListFederationDatabasesRequest\"H\n\x16\x46\x65\x64\x65rationDatabaseInfo\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08\x65ndpoint\x18\x02 \x01(\t\x12\x0e\n\x06status\x18\x03 \x01(\t\"l\n\x1fListFederationDatabasesResponse\x12\x15\n\rself_location\x18\x01 \x01(\t\x12\x32\n\tdatabases\x18\x02 \x03(\x0b\x32\x1f.ydb_tpu.FederationDatabaseInfo\"\x16\n\x14ListEndpointsRequest\"-\n\x0c\x45ndpointInfo\x12\x0f\n\x07\x61\x64\x64ress\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\x05\"A\n\x15ListEndpointsResponse\x12(\n\tendpoints\x18\x01 \x03(\x0b\x32\x15.ydb_tpu.EndpointInfob\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ydb_tpu_api_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EXECUTEQUERYREQUEST._serialized_start=30
  _EXECUTEQUERYREQUEST._serialized_end=84
  _EXECUTEQUERYRESPONSE._serialized_start=87
  _EXECUTEQUERYRESPONSE._serialized_end=286
  _EXECUTEQUERYRESPONSE_STATUS._serialized_start=254
  _EXECUTEQUERYRESPONSE_STATUS._serialized_end=286
  _CREATESESSIONREQUEST._serialized_start=288
  _CREATESESSIONREQUEST._serialized_end=310
  _CREATESESSIONRESPONSE._serialized_start=312
  _CREATESESSIONRESPONSE._serialized_end=355
  _DELETESESSIONREQUEST._serialized_start=357
  _DELETESESSIONREQUEST._serialized_end=399
  _DELETESESSIONRESPONSE._serialized_start=401
  _DELETESESSIONRESPONSE._serialized_end=424
  _LISTDIRECTORYREQUEST._serialized_start=426
  _LISTDIRECTORYREQUEST._serialized_end=462
  _SCHEMEENTRY._serialized_start=464
  _SCHEMEENTRY._serialized_end=505
  _LISTDIRECTORYRESPONSE._serialized_start=507
  _LISTDIRECTORYRESPONSE._serialized_end=585
  _DESCRIBETABLEREQUEST._serialized_start=587
  _DESCRIBETABLEREQUEST._serialized_end=623
  _COLUMNMETA._serialized_start=625
  _COLUMNMETA._serialized_end=683
  _DESCRIBETABLERESPONSE._serialized_start=686
  _DESCRIBETABLERESPONSE._serialized_end=852
  _TOPICWRITEREQUEST._serialized_start=854
  _TOPICWRITEREQUEST._serialized_end=948
  _TOPICWRITERESPONSE._serialized_start=950
  _TOPICWRITERESPONSE._serialized_end=1020
  _TOPICREADREQUEST._serialized_start=1022
  _TOPICREADREQUEST._serialized_end=1088
  _TOPICMESSAGE._serialized_start=1090
  _TOPICMESSAGE._serialized_end=1153
  _TOPICREADRESPONSE._serialized_start=1155
  _TOPICREADRESPONSE._serialized_end=1230
  _STREAMREADREQUEST._serialized_start=1232
  _STREAMREADREQUEST._serialized_end=1349
  _STREAMWRITEITEM._serialized_start=1351
  _STREAMWRITEITEM._serialized_end=1443
  _STREAMWRITEACK._serialized_start=1445
  _STREAMWRITEACK._serialized_end=1511
  _TOPICCOMMITREQUEST._serialized_start=1513
  _TOPICCOMMITREQUEST._serialized_end=1601
  _TOPICCOMMITRESPONSE._serialized_start=1603
  _TOPICCOMMITRESPONSE._serialized_end=1639
  _EXPORTREQUEST._serialized_start=1641
  _EXPORTREQUEST._serialized_end=1703
  _EXPORTRESPONSE._serialized_start=1705
  _EXPORTRESPONSE._serialized_end=1805
  _IMPORTREQUEST._serialized_start=1807
  _IMPORTREQUEST._serialized_end=1867
  _IMPORTRESPONSE._serialized_start=1869
  _IMPORTRESPONSE._serialized_end=1914
  _LISTBACKUPSREQUEST._serialized_start=1916
  _LISTBACKUPSREQUEST._serialized_end=1936
  _BACKUPINFO._serialized_start=1938
  _BACKUPINFO._serialized_end=1996
  _LISTBACKUPSRESPONSE._serialized_start=1998
  _LISTBACKUPSRESPONSE._serialized_end=2057
  _CREATERESOURCEREQUEST._serialized_start=2059
  _CREATERESOURCEREQUEST._serialized_end=2125
  _CREATERESOURCERESPONSE._serialized_start=2127
  _CREATERESOURCERESPONSE._serialized_end=2166
  _ACQUIRERESOURCEREQUEST._serialized_start=2168
  _ACQUIRERESOURCEREQUEST._serialized_end=2222
  _ACQUIRERESOURCERESPONSE._serialized_start=2224
  _ACQUIRERESOURCERESPONSE._serialized_end=2305
  _DESCRIBERESOURCEREQUEST._serialized_start=2307
  _DESCRIBERESOURCEREQUEST._serialized_end=2346
  _DESCRIBERESOURCERESPONSE._serialized_start=2348
  _DESCRIBERESOURCERESPONSE._serialized_end=2434
  _EXECUTESCRIPTREQUEST._serialized_start=2436
  _EXECUTESCRIPTREQUEST._serialized_end=2474
  _SCRIPTSTATEMENTRESULT._serialized_start=2476
  _SCRIPTSTATEMENTRESULT._serialized_end=2541
  _EXECUTESCRIPTRESPONSE._serialized_start=2543
  _EXECUTESCRIPTRESPONSE._serialized_end=2658
  _GETOPERATIONREQUEST._serialized_start=2660
  _GETOPERATIONREQUEST._serialized_end=2693
  _OPERATIONSTATUS._serialized_start=2695
  _OPERATIONSTATUS._serialized_end=2782
  _LISTOPERATIONSREQUEST._serialized_start=2784
  _LISTOPERATIONSREQUEST._serialized_end=2807
  _LISTOPERATIONSRESPONSE._serialized_start=2809
  _LISTOPERATIONSRESPONSE._serialized_end=2879
  _CANCELOPERATIONREQUEST._serialized_start=2881
  _CANCELOPERATIONREQUEST._serialized_end=2917
  _HEALTHCHECKREQUEST._serialized_start=2919
  _HEALTHCHECKREQUEST._serialized_end=2939
  _HEALTHISSUE._serialized_start=2941
  _HEALTHISSUE._serialized_end=3008
  _HEALTHCHECKRESPONSE._serialized_start=3010
  _HEALTHCHECKRESPONSE._serialized_end=3085
  _COORDSESSIONREQUEST._serialized_start=3087
  _COORDSESSIONREQUEST._serialized_end=3147
  _COORDSESSIONRESPONSE._serialized_start=3149
  _COORDSESSIONRESPONSE._serialized_end=3206
  _COORDSEMAPHOREREQUEST._serialized_start=3208
  _COORDSEMAPHOREREQUEST._serialized_end=3314
  _COORDSEMAPHORERESPONSE._serialized_start=3316
  _COORDSEMAPHORERESPONSE._serialized_end=3436
  _GETCONFIGREQUEST._serialized_start=3438
  _GETCONFIGREQUEST._serialized_end=3456
  _GETCONFIGRESPONSE._serialized_start=3458
  _GETCONFIGRESPONSE._serialized_end=3523
  _SETCONFIGREQUEST._serialized_start=3525
  _SETCONFIGREQUEST._serialized_end=3581
  _SETCONFIGRESPONSE._serialized_start=3583
  _SETCONFIGRESPONSE._serialized_end=3634
  _WHOAMIREQUEST._serialized_start=3636
  _WHOAMIREQUEST._serialized_end=3651
  _WHOAMIRESPONSE._serialized_start=3653
  _WHOAMIRESPONSE._serialized_end=3706
  _TABLECOLUMNSPEC._serialized_start=3708
  _TABLECOLUMNSPEC._serialized_end=3771
  _CREATETABLEREQUEST._serialized_start=3774
  _CREATETABLEREQUEST._serialized_end=3903
  _CREATETABLERESPONSE._serialized_start=3905
  _CREATETABLERESPONSE._serialized_end=3941
  _DROPTABLEREQUEST._serialized_start=3943
  _DROPTABLEREQUEST._serialized_end=3975
  _DROPTABLERESPONSE._serialized_start=3977
  _DROPTABLERESPONSE._serialized_end=4011
  _ALTERTABLEADDCOLUMNSREQUEST._serialized_start=4013
  _ALTERTABLEADDCOLUMNSREQUEST._serialized_end=4103
  _ALTERTABLERESPONSE._serialized_start=4105
  _ALTERTABLERESPONSE._serialized_end=4164
  _COPYTABLEREQUEST._serialized_start=4166
  _COPYTABLEREQUEST._serialized_end=4210
  _COPYTABLERESPONSE._serialized_start=4212
  _COPYTABLERESPONSE._serialized_end=4260
  _TXCONTROL._serialized_start=4262
  _TXCONTROL._serialized_end=4319
  _EXECUTEDATAQUERYREQUEST._serialized_start=4321
  _EXECUTEDATAQUERYREQUEST._serialized_end=4411
  _EXECUTEDATAQUERYRESPONSE._serialized_start=4413
  _EXECUTEDATAQUERYRESPONSE._serialized_end=4524
  _BULKUPSERTREQUEST._serialized_start=4526
  _BULKUPSERTREQUEST._serialized_end=4579
  _BULKUPSERTRESPONSE._serialized_start=4581
  _BULKUPSERTRESPONSE._serialized_end=4647
  _READTABLEREQUEST._serialized_start=4649
  _READTABLEREQUEST._serialized_end=4718
  _READTABLEBATCH._serialized_start=4720
  _READTABLEBATCH._serialized_end=4770
  _EXPLAINQUERYREQUEST._serialized_start=4772
  _EXPLAINQUERYREQUEST._serialized_end=4806
  _EXPLAINQUERYRESPONSE._serialized_start=4808
  _EXPLAINQUERYRESPONSE._serialized_end=4864
  _KVVOLUMEREQUEST._serialized_start=4866
  _KVVOLUMEREQUEST._serialized_end=4897
  _KVVOLUMERESPONSE._serialized_start=4899
  _KVVOLUMERESPONSE._serialized_end=4932
  _KVWRITEREQUEST._serialized_start=4934
  _KVWRITEREQUEST._serialized_end=4994
  _KVWRITERESPONSE._serialized_start=4996
  _KVWRITERESPONSE._serialized_end=5028
  _KVREADREQUEST._serialized_start=5030
  _KVREADREQUEST._serialized_end=5074
  _KVREADRESPONSE._serialized_start=5076
  _KVREADRESPONSE._serialized_end=5137
  _KVLISTRANGEREQUEST._serialized_start=5139
  _KVLISTRANGEREQUEST._serialized_end=5216
  _KVPAIR._serialized_start=5218
  _KVPAIR._serialized_end=5254
  _KVLISTRANGERESPONSE._serialized_start=5256
  _KVLISTRANGERESPONSE._serialized_end=5324
  _KVDELETERANGEREQUEST._serialized_start=5326
  _KVDELETERANGEREQUEST._serialized_end=5390
  _KVDELETERANGERESPONSE._serialized_start=5392
  _KVDELETERANGERESPONSE._serialized_end=5447
  _KVRENAMEREQUEST._serialized_start=5449
  _KVRENAMEREQUEST._serialized_end=5516
  _KVRENAMERESPONSE._serialized_start=5518
  _KVRENAMERESPONSE._serialized_end=5568
  _LISTFEDERATIONDATABASESREQUEST._serialized_start=5570
  _LISTFEDERATIONDATABASESREQUEST._serialized_end=5602
  _FEDERATIONDATABASEINFO._serialized_start=5604
  _FEDERATIONDATABASEINFO._serialized_end=5676
  _LISTFEDERATIONDATABASESRESPONSE._serialized_start=5678
  _LISTFEDERATIONDATABASESRESPONSE._serialized_end=5786
  _LISTENDPOINTSREQUEST._serialized_start=5788
  _LISTENDPOINTSREQUEST._serialized_end=5810
  _ENDPOINTINFO._serialized_start=5812
  _ENDPOINTINFO._serialized_end=5857
  _LISTENDPOINTSRESPONSE._serialized_start=5859
  _LISTENDPOINTSRESPONSE._serialized_end=5924
# @@protoc_insertion_point(module_scope)
