"""Cluster communication, ported one slice at a time.

encoding  versioned binary encode/decode (bufferlist + denc analog): the
          codec of the OSDMap, its incrementals and the CRUSH map
          (osd.map_codec, tools.crushtool).  Pure Python.
"""

from .encoding import Decoder, Encoder

__all__ = ["Encoder", "Decoder"]
