"""The static-analysis gate over the port: ``python -m ceph_tpu.analysis
ceph_tpu_torch`` (concurrency and lock lints, pure AST work) reports no
finding, as tier-1's gate requires of the reference package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_has_no_static_analysis_findings():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu.analysis", "ceph_tpu_torch"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_port_locks_are_named():
    """No bare threading lock in the port: every lock comes from
    common.lockdep.make_lock, so lock-order checking sees it (the two
    registry singletons carry the reference's stated exemptions)."""
    from ceph_tpu import analysis
    report = analysis.run(os.path.join(ROOT, "ceph_tpu_torch"),
                          checks=["bare-lock"])
    assert not report.findings
    paths = [f.path for f, _why in report.suppressed]
    assert len(paths) == 2
    assert all(p.endswith(os.path.join("ec", "registry.py")) for p in paths)
