"""Cluster communication, ported one slice at a time.

encoding   versioned binary encode/decode (bufferlist + denc analog): the
           codec of the OSDMap, its incrementals, the CRUSH map and every
           message.  Pure Python.
features   the feature bits a messenger advertises and requires
message    Message base + type registry (the port's own registry;
           ceph_tpu_torch.messages holds the concrete types)
messenger  Messenger/Connection/Dispatcher/Policy abstraction
           (msg/Messenger.h:120, msg/Policy.h); ``Messenger.create``
           builds the loopback stack only (the TCP and ici stacks raise)
loopback   the in-process stack: one delivery thread a messenger, every
           frame encoded and decoded
"""

from .encoding import Decoder, Encoder
from .message import Message, register_message
from .messenger import ConnectionPolicy, Dispatcher, EntityName, Messenger

__all__ = [
    "Encoder", "Decoder", "Message", "register_message",
    "Messenger", "Dispatcher", "EntityName", "ConnectionPolicy",
]
