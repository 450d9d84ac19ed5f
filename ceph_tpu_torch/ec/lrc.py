"""LRC — Locally Repairable Code built by *layering* other plugins
(src/erasure-code/lrc/ErasureCodeLrc.cc analog).

The profile describes chunk positions with a `mapping` string and a
JSON `layers` list; each layer names the positions it sees ('D' = data
the layer encodes, 'c' = coding it produces, '_' = not in this layer)
and the sub-plugin profile that does the math:

    mapping=__DD__DD
    layers=[["_cDD_cDD", {"plugin": "jerasure", "k": "2", "m": "1"}],
            ["cDDDcDDD"? ...]]

Encode walks the layers in order: a layer reads the current values at
its 'D' positions and writes its 'c' positions (so later layers can
protect earlier layers' parities — exactly the reference's pyramid
construction).  Decode walks layers smallest-repair-first: any layer
whose surviving members suffice repairs its own missing positions
locally; iterate until stable (ErasureCodeLrc::_minimum_to_decode
layer-picking semantics).  Each layer's math is a registry sub-plugin,
recursively, built with the LRC codec's runtime and torch device, so layer
encodes are the same batched GF(2^8) products.
"""

from __future__ import annotations

import json

import numpy as np

from .base import SIMD_ALIGN, runtime_of
from .interface import ErasureCodeInterface, ErasureCodeProfile
from .registry import instance as registry_instance, register


class _Layer:
    def __init__(self, mapping: str, profile: dict, device=None):
        self.mapping = mapping
        self.data_pos = [i for i, ch in enumerate(mapping) if ch == "D"]
        self.coding_pos = [i for i, ch in enumerate(mapping) if ch == "c"]
        prof = dict(profile)
        prof.setdefault("k", str(len(self.data_pos)))
        prof.setdefault("m", str(len(self.coding_pos)))
        plugin = prof.pop("plugin", "jerasure")
        self.codec = registry_instance().factory(plugin, prof, device)
        if self.codec.get_data_chunk_count() != len(self.data_pos) \
                or self.codec.get_coding_chunk_count() \
                != len(self.coding_pos):
            raise ValueError(
                f"layer {mapping!r}: sub-plugin k/m do not match the "
                f"D/c counts")

    @property
    def members(self) -> list[int]:
        return self.data_pos + self.coding_pos


class ErasureCodeLrc(ErasureCodeInterface):
    """Interface-level plugin (not a matrix code itself: the layers are)."""

    supports_rmw_striping = False

    def __init__(self):
        self.mapping = ""
        self.layers: list[_Layer] = []
        self.runtime = "cuda"
        #: the device of the layers' cuda runtime (None: the card)
        self.device = None

    # -- init -----------------------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        self.mapping = profile.get("mapping", "")
        if not self.mapping:
            raise ValueError("lrc requires a mapping= string")
        layers = profile.get("layers", "")
        if isinstance(layers, str):
            layers = json.loads(layers) if layers else []
        if not layers:
            raise ValueError("lrc requires a layers= JSON list")
        self.runtime = runtime_of(profile)
        self.layers = []
        for entry in layers:
            lmap, lprof = entry[0], (entry[1] if len(entry) > 1 else {})
            if len(lmap) != len(self.mapping):
                raise ValueError(
                    f"layer {lmap!r} length != mapping {self.mapping!r}")
            if isinstance(lprof, str):
                lprof = json.loads(lprof) if lprof else {}
            lprof = dict(lprof)
            lprof.setdefault("runtime", self.runtime)
            self.layers.append(_Layer(lmap, lprof, self.device))
        covered = {p for l in self.layers for p in l.members}
        if covered != set(range(len(self.mapping))):
            raise ValueError(
                f"layers cover {sorted(covered)}; mapping needs all of "
                f"0..{len(self.mapping) - 1}")

    # -- geometry -------------------------------------------------------------

    def get_chunk_count(self) -> int:
        return len(self.mapping)

    def get_data_chunk_count(self) -> int:
        return sum(1 for ch in self.mapping if ch == "D")

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        return 1

    def get_chunk_size(self, stripe_width: int) -> int:
        k = self.get_data_chunk_count()
        # the chunk must be SIMD_ALIGN-aligned so every layer's stripe
        # (layer_k * chunk) re-pads to itself — otherwise layer parities
        # come out longer than the data chunks
        from .base import SIMD_ALIGN
        align = k * SIMD_ALIGN
        padded = (stripe_width + align - 1) // align * align
        return padded // k

    def get_chunk_mapping(self) -> list:
        return []

    # -- encode ---------------------------------------------------------------

    def _data_positions(self) -> list[int]:
        return [i for i, ch in enumerate(self.mapping) if ch == "D"]

    def encode(self, want_to_encode: set, data: bytes) -> dict:
        k = self.get_data_chunk_count()
        chunk = self.get_chunk_size(len(data))
        padded = np.zeros(k * chunk, dtype=np.uint8)
        padded[:len(data)] = np.frombuffer(data, dtype=np.uint8)
        split = padded.reshape(k, chunk)
        values: dict[int, np.ndarray] = {}
        for idx, pos in enumerate(self._data_positions()):
            values[pos] = split[idx]
        for layer in self.layers:
            stripe = b"".join(values[p].tobytes() for p in layer.data_pos)
            enc = layer.codec.encode(
                set(range(len(layer.members))), stripe)
            for ci, pos in enumerate(layer.coding_pos):
                values[pos] = np.frombuffer(
                    enc[len(layer.data_pos) + ci], dtype=np.uint8)
        return {i: values[i].tobytes() for i in want_to_encode}

    def encode_chunks(self, data_chunks):
        raise NotImplementedError("lrc encodes via its layers")

    # -- decode (layer-local repair first) ------------------------------------

    def minimum_to_decode(self, want_to_read: set, available: set) -> set:
        plan = self._repair_plan(set(want_to_read), set(available))
        if plan is None:
            raise IOError(
                f"lrc cannot decode {sorted(want_to_read - available)}")
        return plan

    def minimum_to_decode_with_cost(self, want_to_read: set,
                                    available: dict) -> tuple[set, int]:
        chosen = self.minimum_to_decode(set(want_to_read), set(available))
        return chosen, sum(available.get(i, 1) for i in chosen)

    def _repair_plan(self, want: set, available: set):
        """Chunks to read so that iterated layer-local repair reaches
        `want`; None if unrecoverable."""
        have = set(available)
        reads: set = set()
        progress = True
        while not want <= have and progress:
            progress = False
            # smallest layer first: local repair reads fewest chunks
            for layer in sorted(self.layers, key=lambda l: len(l.members)):
                members = set(layer.members)
                lost = members - have
                if not lost:
                    continue
                surviving = members & have
                try:
                    need = layer.codec.minimum_to_decode(
                        self._to_layer(layer, lost),
                        self._to_layer(layer, surviving))
                except IOError:
                    continue
                reads |= {layer.members[i] for i in need} & available
                have |= lost
                progress = True
        if want <= have:
            return (reads | (want & available))
        return None

    @staticmethod
    def _to_layer(layer: _Layer, positions: set) -> set:
        return {layer.members.index(p) for p in positions
                if p in layer.members}

    def decode(self, want_to_read: set, chunks: dict) -> dict:
        values = {i: np.frombuffer(v, dtype=np.uint8)
                  for i, v in chunks.items()}
        want = set(want_to_read)
        progress = True
        while not want <= set(values) and progress:
            progress = False
            for layer in sorted(self.layers, key=lambda l: len(l.members)):
                members = set(layer.members)
                lost = members - set(values)
                if not lost:
                    continue
                surviving = members & set(values)
                lchunks = {layer.members.index(p): values[p].tobytes()
                           for p in surviving}
                try:
                    got = layer.codec.decode(
                        self._to_layer(layer, lost), lchunks)
                except IOError:
                    continue
                for li, blob in got.items():
                    values[layer.members[li]] = np.frombuffer(
                        blob, dtype=np.uint8)
                progress = True
        missing = want - set(values)
        if missing:
            raise IOError(f"lrc cannot decode {sorted(missing)}")
        return {i: values[i].tobytes() for i in want}

    def decode_concat(self, chunks: dict) -> bytes:
        data_pos = self._data_positions()
        out = self.decode(set(data_pos), chunks)
        return b"".join(out[i] for i in data_pos)

    def create_rule(self, name: str, crush_map) -> int:
        from ceph_tpu_torch.crush.builder import add_simple_rule
        return add_simple_rule(crush_map, -1, 0, "indep")


register("lrc", lambda profile: ErasureCodeLrc())
