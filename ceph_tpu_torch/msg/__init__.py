"""Cluster communication, ported one slice at a time.

encoding   versioned binary encode/decode (bufferlist + denc analog): the
           codec of the OSDMap, its incrementals, the CRUSH map and every
           message.  Pure Python.
features   the feature bits a messenger advertises and requires
message    Message base + type registry (the port's own registry;
           ceph_tpu_torch.messages holds the concrete types)
messenger  Messenger/Connection/Dispatcher/Policy abstraction
           (msg/Messenger.h:120, msg/Policy.h); ``Messenger.create``
           builds the TCP and loopback stacks (the ici stacks raise)
event_tcp  the default TCP stack ("async"): one selector loop and one
           dispatch thread a messenger (AsyncMessenger's event centers)
async_tcp  the thread-per-connection TCP stack ("threaded") and the
           v1-lite handshake both stacks speak, cephx included
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
