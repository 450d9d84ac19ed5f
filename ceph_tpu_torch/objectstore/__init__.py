"""Local persistence (reference layer 3: src/os/ ObjectStore + src/kv/).

ObjectStore is the OSD's storage engine contract: collections (one per PG)
hold objects with byte data and omap key/value attributes; all mutations ride
atomic compound Transactions (os/ObjectStore.h:306) applied via
queue_transactions (os/ObjectStore.h:1460).

Backends: MemStore (the unit-test fake, src/os/memstore/), FileStore
(directory tree + write-ahead journal with crc'd frames and mount-time replay,
src/os/filestore/ structure) and BlueStoreLite (``bluestore.py``: a block file
with a crc per block, metadata and deferred writes in a LogDB, block
compression; src/os/bluestore/ structure).  KeyValueDB (src/kv/KeyValueDB.h) backs the mon
store, with MemDB and a compacting file-backed LogDB.
"""

from .transaction import Transaction
from .objectstore import ObjectStore, create as create_objectstore
from .kv import KeyValueDB, MemDB, LogDB

__all__ = ["Transaction", "ObjectStore", "create_objectstore",
           "KeyValueDB", "MemDB", "LogDB"]
