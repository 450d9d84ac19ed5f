"""The port's crushtool --test analog (ceph_tpu_torch.tools.crush_test)
against the reference's ceph_tpu.tools.crush_test: the same lines, byte for
byte, from the port's BatchMapper on the CPU.
"""

import io

import pytest
import torch

from ceph_tpu.crush import builder as jb
from ceph_tpu.tools import crush_test as j_crush_test
from ceph_tpu_torch.crush import builder as tb
from ceph_tpu_torch.tools import crush_test as t_crush_test


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(args, jmap, tmap, rid, num_rep, max_x):
    outs = []
    for run, m, kw in ((j_crush_test.run_test, jmap, {}),
                       (t_crush_test.run_test, tmap, {"device": "cpu"})):
        buf = io.StringIO()
        run(m, [rid], 0, max_x, num_rep, out=buf, **args, **kw)
        outs.append(buf.getvalue())
    return outs


@pytest.mark.parametrize("hosts,max_x", [(16, 255), (400, 127)])
def test_crush_test_prints_what_the_reference_prints(hosts, max_x):
    """run_test with --show-mappings --show-utilization: byte-equal
    output (the timing lines of --show-statistics are main()'s)."""
    jmap, _root, rid = jb.build_two_level_map(hosts, 4)
    tmap, _root, trid = tb.build_two_level_map(hosts, 4)
    assert trid == rid
    jout, tout = _run_both({"show_mappings": True, "show_utilization": True},
                           jmap, tmap, rid, 3, max_x)
    assert tout == jout
    assert tout.count("CRUSH rule") == max_x + 1


def test_crush_test_cli_on_the_cpu(capsys):
    assert t_crush_test.main(["--hosts", "4", "--per-host", "2",
                              "--max-x", "31", "--device", "cpu",
                              "--show-statistics"]) == 0
    out = capsys.readouterr().out
    assert "rule 0 num_rep 3 result size == 3:\t32/32" in out
    assert "mappings/s" in out
    assert t_crush_test.main(["--osds", "12", "--max-x", "15",
                              "--backend", "scalar"]) == 0
    assert "result size == 3:\t16/16" in capsys.readouterr().out
