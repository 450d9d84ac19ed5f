"""crushtool's text map format in the port held against the JAX package.

Mirrors tests/test_crush_text.py (all but its two live-cluster tests): each
map is compiled by both packages (``crush.text.compile_text``), and the port's
map must encode to the reference's bytes (``map_codec.encode_crush``), carry
the same name tables, decompile to the same text and place every x as the
reference's map does under the port's scalar ``crush_do_rule``; the port's
``tools.crushtool`` writes the reference tool's files and tree.  The
tolerance is exact equality: bytes, text and placements.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ceph_tpu.crush import build_two_level_map as ref_build
from ceph_tpu.crush import text as ref_text
from ceph_tpu.msg.encoding import Encoder as RefEncoder
from ceph_tpu.osd.map_codec import encode_crush as ref_encode_crush
from ceph_tpu.tools import crushtool as ref_ct
from ceph_tpu_torch.convert import crush_map_from_reference
from ceph_tpu_torch.crush import build_two_level_map
from ceph_tpu_torch.crush.mapper_ref import crush_do_rule
from ceph_tpu_torch.crush.text import (CompileError, compile_text,
                                       decompile)
from ceph_tpu_torch.msg.encoding import Decoder, Encoder
from ceph_tpu_torch.osd.map_codec import decode_crush, encode_crush
from ceph_tpu_torch.tools import crushtool as ct

from test_crush_text import CLASS_RULES, SAMPLE

RW6 = [0x10000] * 6


def crush_bytes(m) -> bytes:
    e = Encoder()
    encode_crush(m, e)
    return e.tobytes()


def ref_crush_bytes(m) -> bytes:
    e = RefEncoder()
    ref_encode_crush(m, e)
    return e.tobytes()


def names_of(n) -> tuple:
    return (n.types, n.items, n.rules, n.classes)


def compile_both(text: str):
    """The port's compiled map and names, held to the reference's."""
    m, names = compile_text(text)
    rm, rnames = ref_text.compile_text(text)
    assert crush_bytes(m) == ref_crush_bytes(rm)
    assert names_of(names) == names_of(rnames)
    assert decompile(m, names) == ref_text.decompile(rm, rnames)
    return m, names


def same_rows(m1, m2, rule, numrep, rw, xs=range(64)):
    for x in xs:
        assert crush_do_rule(m1, rule, x, numrep, rw) == \
            crush_do_rule(m2, rule, x, numrep, rw), x


class TestCompile:
    def test_compiles_sample_like_reference(self):
        m, names = compile_both(SAMPLE)
        assert m.max_devices == 6
        assert names.items[-2] == "node-a"
        assert m.tunables.choose_total_tries == 50

    def test_mapping_works(self):
        m, _ = compile_both(SAMPLE)
        rm, _ = ref_text.compile_text(SAMPLE)
        for x in range(64):
            out = crush_do_rule(m, 0, x, 3, RW6)
            assert len(out) == 3 and len(set(out)) == 3
        same_rows(m, crush_map_from_reference(rm), 0, 3, RW6)

    def test_declaration_order_free(self):
        lines = SAMPLE.splitlines()
        ri = next(i for i, l in enumerate(lines)
                  if l.startswith("root default"))
        re_ = next(i for i in range(ri, len(lines))
                   if lines[i].strip() == "}") + 1
        hi = next(i for i, l in enumerate(lines)
                  if l.startswith("host node-a"))
        root_blk = lines[ri:re_]
        rest = lines[:ri] + lines[re_:]
        lines2 = rest[:hi] + root_blk + rest[hi:]
        m2, _ = compile_both("\n".join(lines2))
        m1, _ = compile_both(SAMPLE)
        same_rows(m1, m2, 0, 3, RW6, range(32))

    @pytest.mark.parametrize("text", [
        "tunable bogus_knob 1",
        "host h { id -1 alg warp hash 0 }\ntype 1 host",
        SAMPLE + "\nrule bad { id 9 type replicated min_size 1 "
        "max_size 10 step take default class nvme step emit }",
        "rule r { id 0 type replicated min_size 1 max_size 10 step take "
        "nonexistent step emit }",
        "type 1 host\nhost h { id 2 alg straw2 hash 0 }",
        ("rule a { id 0 type replicated min_size 1 max_size 10 "
         "step emit }\n") * 2,
        "type 1 host\nhost h { id -1 alg straw2 hash 0 }\n"
        "host h { id -2 alg straw2 hash 0 }",
    ])
    def test_errors_as_reference(self, text):
        """Every text the reference refuses, the port refuses with the
        same exception class."""
        with pytest.raises((ref_text.CompileError, ValueError)) as ref_e:
            ref_text.compile_text(text)
        with pytest.raises((CompileError, ValueError)) as e:
            compile_text(text)
        assert type(e.value).__name__ == type(ref_e.value).__name__


class TestRoundTrip:
    def test_text_map_text(self):
        m1, n1 = compile_both(SAMPLE)
        m2, n2 = compile_both(decompile(m1, n1))
        assert names_of(n2) == names_of(n1)
        assert crush_bytes(m2) == crush_bytes(m1)
        same_rows(m1, m2, 0, 3, RW6)

    def test_builder_map_survives(self):
        crush, _root, rule = build_two_level_map(4, 3)
        rcrush, _r, _rr = ref_build(4, 3)
        assert crush_bytes(crush) == ref_crush_bytes(rcrush)
        text = decompile(crush)
        assert text == ref_text.decompile(rcrush)
        m2, _ = compile_both(text)
        same_rows(crush, m2, rule, 3, [0x10000] * 12, range(128))


class TestCrushtoolCli:
    def test_compile_decompile_tree_build(self, tmp_path):
        txt_path = tmp_path / "map.txt"
        txt_path.write_text(SAMPLE)
        bin_path = str(tmp_path / "map.bin")
        ref_bin = str(tmp_path / "ref.bin")
        assert ct.main(["-c", str(txt_path), "-o", bin_path]) == 0
        assert ref_ct.main(["-c", str(txt_path), "-o", ref_bin]) == 0
        with open(bin_path, "rb") as a, open(ref_bin, "rb") as b:
            assert a.read() == b.read()
        m, names = ct.read_binary(ref_bin)
        assert names.items[-2] == "node-a"
        out_path = tmp_path / "out.txt"
        ref_out = tmp_path / "ref_out.txt"
        assert ct.main(["-d", bin_path, "-o", str(out_path)]) == 0
        assert ref_ct.main(["-d", bin_path, "-o", str(ref_out)]) == 0
        assert out_path.read_text() == ref_out.read_text()
        m2, _ = compile_both(out_path.read_text())
        same_rows(m, m2, 0, 3, RW6, range(32))
        rm, rnames = ref_ct.read_binary(bin_path)
        tree = ct.tree_lines(m, names)
        assert tree == ref_ct.tree_lines(rm, rnames)
        assert "root default" in "\n".join(tree)
        built = str(tmp_path / "b.bin")
        ref_built = str(tmp_path / "rb.bin")
        layers = ["host", "straw2", "2", "root", "straw2", "0"]
        assert ct.main(["--build", "--num-osds", "6", *layers, "-o",
                        built]) == 0
        assert ref_ct.main(["--build", "--num-osds", "6", *layers, "-o",
                            ref_built]) == 0
        with open(built, "rb") as a, open(ref_built, "rb") as b:
            assert a.read() == b.read()
        bm, _bn = ct.read_binary(built)
        assert len([b for b in bm.buckets if b is not None]) == 4
        for x in range(32):
            assert len(set(crush_do_rule(bm, 0, x, 3, RW6))) == 3

    def test_tree_prints_like_reference(self, tmp_path, capsys):
        bin_path = str(tmp_path / "m.bin")
        (tmp_path / "m.txt").write_text(SAMPLE)
        assert ct.main(["-c", str(tmp_path / "m.txt"), "-o", bin_path]) == 0
        assert ct.main(["--tree", bin_path]) == 0
        mine = capsys.readouterr().out
        assert ref_ct.main(["--tree", bin_path]) == 0
        assert mine == capsys.readouterr().out


class TestValidation:
    def test_build_without_root_layer_reaches_all_osds(self, tmp_path):
        out = str(tmp_path / "x.bin")
        ref_out = str(tmp_path / "rx.bin")
        assert ct.main(["--build", "--num-osds", "8", "host", "straw2",
                        "2", "-o", out]) == 0
        assert ref_ct.main(["--build", "--num-osds", "8", "host", "straw2",
                            "2", "-o", ref_out]) == 0
        with open(out, "rb") as a, open(ref_out, "rb") as b:
            assert a.read() == b.read()
        m, _ = ct.read_binary(out)
        seen = set()
        for x in range(512):
            res = crush_do_rule(m, 0, x, 3, [0x10000] * 8)
            assert len(set(res)) == 3
            seen.update(res)
        assert seen == set(range(8))


class TestDeviceClasses:
    def _compile(self):
        return compile_both(SAMPLE.replace(
            "# end crush map", CLASS_RULES + "\n# end crush map"))

    def test_shadow_trees_built(self):
        m, _names = self._compile()
        ssd_root = m.bucket(m.class_bucket[(-1, "ssd")])
        assert len(ssd_root.items) == 1
        assert sorted(m.bucket(ssd_root.items[0]).items) == [2, 3]
        hdd_root = m.bucket(m.class_bucket[(-1, "hdd")])
        hdd_devs = set()
        for h in hdd_root.items:
            hdd_devs.update(m.bucket(h).items)
        assert hdd_devs == {0, 1, 4, 5}
        assert hdd_root.weight == 5 * 0x10000

    def test_class_rules_place_only_in_class(self):
        m, _names = self._compile()
        for x in range(128):
            out = crush_do_rule(m, 2, x, 2, RW6)
            assert out and set(out) <= {2, 3}, out
            out = crush_do_rule(m, 3, x, 3, RW6)
            assert out and set(out) <= {0, 1, 4, 5}, out

    def test_batched_mapper_class_rule(self):
        """The port's BatchMapper (CPU) places a class rule on the shadow
        tree as the scalar rule engine does."""
        from ceph_tpu_torch.crush.mapper_torch import BatchMapper
        m, _names = self._compile()
        bm = BatchMapper(m, device="cpu")
        out = bm.do_rule(3, np.arange(256, dtype=np.uint32), 3,
                         torch.full((6,), 0x10000, dtype=torch.int64))
        out = out.numpy()
        assert set(out[out >= 0].tolist()) <= {0, 1, 4, 5}
        for x in range(0, 256, 17):
            assert [o for o in out[x] if o >= 0] == \
                crush_do_rule(m, 3, x, 3, RW6)

    def test_decompile_roundtrip_with_classes(self):
        m, names = self._compile()
        text2 = decompile(m, names)
        assert "step take default class ssd" in text2
        assert text2.count("root default {") == 1
        m2, _ = compile_both(text2)
        same_rows(m, m2, 2, 2, RW6)
        same_rows(m, m2, 3, 3, RW6)

    def test_unknown_class_errors(self):
        text = SAMPLE.replace(
            "# end crush map",
            "rule bad { id 2\n type replicated\n min_size 1\n"
            " max_size 10\n step take default class nvme\n"
            " step emit\n}\n# end crush map")
        with pytest.raises(CompileError):
            compile_text(text)

    def test_codec_roundtrip_with_classes(self):
        m, _names = self._compile()
        m2 = decode_crush(Decoder(crush_bytes(m)))
        assert m2.class_bucket == m.class_bucket
        assert crush_bytes(m2) == crush_bytes(m)
        same_rows(m, m2, 2, 2, RW6, range(32))
