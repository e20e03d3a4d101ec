"""Blob storage plane: erasure-coded blob groups under the port's
``BlobStore`` surface.

The port's own copy of ``ydb_tpu/blobstorage/``: the erasure codec, the
quorum ``DSProxy`` over ``VDisk``s, ``GroupBlobStore`` (the seam that puts
a whole ``Cluster`` on a group), PDisk chunk devices with LSM hulls, the
controller's self-heal and BlobDepot. Host numpy, as in the reference.
"""

from ydb_tpu_torch.blobstorage.erasure import ErasureCodec
from ydb_tpu_torch.blobstorage.group import DSProxy, GroupInfo, VDisk
from ydb_tpu_torch.blobstorage.proxy_store import GroupBlobStore

__all__ = ["ErasureCodec", "DSProxy", "GroupInfo", "VDisk",
           "GroupBlobStore"]
