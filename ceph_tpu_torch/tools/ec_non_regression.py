"""Erasure-code non-regression corpus tool
(src/test/erasure-code/ceph_erasure_code_non_regression.cc:113,304-328
analog).

--check re-encodes, for every plugin x technique x (k, m) configuration, a
fixed PRNG payload and byte-compares the chunks with the committed corpus
(tests/golden/ec_corpus/, read in place): any change to the GF math, the
generator constructions, shec windows, lrc layering or clay coupling fails.
It encodes on the codecs' cuda runtime: the card by default, ``--device
cpu`` for the plain torch path.

--create writes such a corpus with the numpy oracle into ``--directory``,
which it requires and which may not be the committed corpus: the corpus is
the reference package's, and this tool never rewrites it.

    python -m ceph_tpu_torch.tools.ec_non_regression --check
    python -m ceph_tpu_torch.tools.ec_non_regression --create --directory D
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "golden", "ec_corpus")

PAYLOAD_LEN = 2111    # deliberately unaligned: pins padding semantics too
SEED = 20260730

LRC_LAYERS = json.dumps([
    ["cDDD____", {"plugin": "jerasure", "technique": "reed_sol_van"}],
    ["____cDDD", {"plugin": "jerasure", "technique": "reed_sol_van"}],
])

#: (name, plugin, profile)
CONFIGS = [
    ("jerasure_rsvan_k4m2", "jerasure",
     {"k": "4", "m": "2", "technique": "reed_sol_van"}),
    ("jerasure_rsvan_k7m3", "jerasure",
     {"k": "7", "m": "3", "technique": "reed_sol_van"}),
    ("jerasure_rsr6_k4m2", "jerasure",
     {"k": "4", "m": "2", "technique": "reed_sol_r6_op"}),
    ("jerasure_cauchy_good_k4m2", "jerasure",
     {"k": "4", "m": "2", "technique": "cauchy_good"}),
    ("jerasure_cauchy_orig_k4m2", "jerasure",
     {"k": "4", "m": "2", "technique": "cauchy_orig"}),
    ("jerasure_liberation_k4m2", "jerasure",
     {"k": "4", "m": "2", "technique": "liberation"}),
    ("jerasure_blaum_roth_k4m2", "jerasure",
     {"k": "4", "m": "2", "technique": "blaum_roth"}),
    ("jerasure_liber8tion_k4m2", "jerasure",
     {"k": "4", "m": "2", "technique": "liber8tion"}),
    ("isa_cauchy_k8m4", "isa",
     {"k": "8", "m": "4", "technique": "cauchy"}),
    ("isa_vand_k4m2", "isa",
     {"k": "4", "m": "2", "technique": "reed_sol_van"}),
    ("shec_k4m3c2", "shec", {"k": "4", "m": "3", "c": "2"}),
    ("lrc_2x3", "lrc", {"mapping": "_DDD_DDD", "layers": LRC_LAYERS}),
    ("clay_k4m2", "clay", {"k": "4", "m": "2"}),
    ("clay_k2m2", "clay", {"k": "2", "m": "2"}),
]


def payload() -> bytes:
    rng = np.random.default_rng(SEED)
    return rng.integers(0, 256, PAYLOAD_LEN, dtype=np.uint8).tobytes()


def codec_for(plugin: str, profile: dict, runtime: str = "cuda",
              device=None):
    """The codec of one corpus configuration on ``runtime``."""
    from ceph_tpu_torch.ec import registry_instance
    return registry_instance().factory(
        plugin, dict(profile, runtime=runtime), device)


def encode_all(codec) -> dict[int, bytes]:
    return codec.encode(set(range(codec.get_chunk_count())), payload())


def create(directory: str) -> int:
    if os.path.realpath(directory) == os.path.realpath(DEFAULT_DIR):
        print(f"refusing to rewrite the committed corpus {DEFAULT_DIR}")
        return 1
    os.makedirs(directory, exist_ok=True)
    for name, plugin, profile in CONFIGS:
        enc = encode_all(codec_for(plugin, profile, "cpu"))
        arrays = {f"chunk_{i}": np.frombuffer(v, dtype=np.uint8)
                  for i, v in enc.items()}
        np.savez_compressed(os.path.join(directory, f"{name}.npz"),
                            **arrays)
        print(f"created {name}: {len(enc)} chunks")
    return 0


def check(directory: str = DEFAULT_DIR, device=None) -> int:
    failures = 0
    for name, plugin, profile in CONFIGS:
        path = os.path.join(directory, f"{name}.npz")
        if not os.path.exists(path):
            print(f"MISSING corpus {name}")
            failures += 1
            continue
        stored = np.load(path)
        enc = encode_all(codec_for(plugin, profile, "cuda", device))
        for i, blob in enc.items():
            want = stored[f"chunk_{i}"].tobytes()
            if blob != want:
                print(f"MISMATCH {name} chunk {i}")
                failures += 1
    if failures == 0:
        print(f"all {len(CONFIGS)} corpus configs bit-identical")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--create", action="store_true")
    g.add_argument("--check", action="store_true")
    ap.add_argument("--directory", default=None,
                    help="corpus directory (--check: default the committed "
                         "corpus; --create: required)")
    ap.add_argument("--device", default=None,
                    help="torch device of the cuda runtime (default: the "
                         "card; 'cpu' runs the plain torch path)")
    args = ap.parse_args(argv)
    if args.create:
        if args.directory is None:
            ap.error("--create requires --directory")
        return create(args.directory)
    return check(args.directory or DEFAULT_DIR, args.device)


if __name__ == "__main__":
    sys.exit(main())
