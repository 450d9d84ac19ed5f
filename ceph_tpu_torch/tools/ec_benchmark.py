"""ceph_erasure_code_benchmark analog
(src/test/erasure-code/ceph_erasure_code_benchmark.cc).

Same flags, same output contract — one line per run:

    <elapsed seconds>\t<total KiB processed>

Usage mirrors the reference (:40-65 usage text):
    python -m ceph_tpu_torch.tools.ec_benchmark --plugin jerasure \
        --parameter k=4 --parameter m=2 --parameter technique=reed_sol_van \
        --size 1048576 --iterations 100 --workload encode
    ... --workload decode --erasures 2 [--erasures-generation exhaustive]

Additions over the reference: --batch (stripes per call — the ECUtil batch
point), --runtime cuda|cpu|native (the card's kernel, the numpy oracle, the
single-core C encode) and --device (the torch device of the cuda runtime:
the card by default, ``cpu`` for the plain torch path).

What is timed is what a caller of encode_chunks/decode_chunks pays with
host data: each call copies its batch to the device, and the last call's
output is copied back to the host (``.cpu()``) before the clock stops.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time
from typing import NamedTuple

import numpy as np

from ceph_tpu_torch.ec import registry_instance
from ceph_tpu_torch.ec.base import to_host


class BenchRun(NamedTuple):
    """One benchmark run: its time and KiB (the output line), the data it
    encoded, the chunks the last call erased (decode) and that call's
    output on the host — what a caller holds against an oracle."""

    elapsed: float
    kib: int
    data: np.ndarray        # (batch, k, chunk) data chunks
    lost: tuple             # erased chunk indices of the last call
    out: np.ndarray         # (n, m or len(lost), chunk) of the last call


def bench_encode(codec, object_size: int, iterations: int,
                 batch: int) -> BenchRun:
    k = codec.get_data_chunk_count()
    chunk = codec.get_chunk_size(object_size)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (batch, k, chunk), dtype=np.uint8)
    # warm (build the kernels, upload the tables) then measure
    to_host(codec.encode_chunks(data))
    total_kib = 0
    t0 = time.perf_counter()
    done = 0
    while done < iterations:
        n = min(batch, iterations - done)
        out = codec.encode_chunks(data[:n])
        done += n
        total_kib += n * object_size // 1024
    out = to_host(out)  # materialize on the host
    return BenchRun(time.perf_counter() - t0, total_kib, data, (), out)


def bench_decode(codec, object_size: int, iterations: int, batch: int,
                 erasures: int, exhaustive: bool) -> BenchRun:
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    chunk = codec.get_chunk_size(object_size)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (batch, k, chunk), dtype=np.uint8)
    parity = to_host(codec.encode_chunks(data))
    full = np.concatenate([data, parity], axis=1)
    if exhaustive:
        patterns = list(itertools.combinations(range(n), erasures))
    else:
        patterns = [tuple(sorted(rng.choice(n, erasures, replace=False)))]
    # warm (the recovery matrices and their tables) then measure
    for lost in patterns:
        chosen = [i for i in range(n) if i not in lost][:k]
        to_host(codec.decode_chunks(chosen, full[:1, chosen], list(lost)))
    total_kib = 0
    t0 = time.perf_counter()
    done = 0
    while done < iterations:
        lost = patterns[done % len(patterns)]
        chosen = [i for i in range(n) if i not in lost][:k]
        m = min(batch, iterations - done)
        out = codec.decode_chunks(chosen, full[:m, chosen], list(lost))
        done += m
        total_kib += m * object_size // 1024
    out = to_host(out)
    return BenchRun(time.perf_counter() - t0, total_kib, data,
                    tuple(int(i) for i in lost), out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ec_benchmark")
    p.add_argument("--plugin", "-p", default="jerasure")
    p.add_argument("--parameter", "-P", action="append", default=[],
                   help="profile key=value (k=, m=, technique=, ...)")
    p.add_argument("--size", "-S", type=int, default=1024 * 1024,
                   help="object size in bytes")
    p.add_argument("--iterations", "-i", type=int, default=100)
    p.add_argument("--workload", "-w", choices=["encode", "decode"],
                   default="encode")
    p.add_argument("--erasures", "-e", type=int, default=1)
    p.add_argument("--erasures-generation", "-E",
                   choices=["random", "exhaustive"], default="random")
    p.add_argument("--batch", type=int, default=64,
                   help="stripes per call")
    p.add_argument("--runtime", choices=["cuda", "cpu", "native"],
                   default="cuda")
    p.add_argument("--device", default=None,
                   help="torch device of the cuda runtime (default: the "
                        "card; 'cpu' runs the plain torch path)")
    p.add_argument("--verbose", "-v", action="store_true")
    args = p.parse_args(argv)

    profile = {"runtime": args.runtime}
    for kv in args.parameter:
        key, _, val = kv.partition("=")
        profile[key] = val
    codec = registry_instance().factory(args.plugin, profile, args.device)

    if args.workload == "encode":
        run = bench_encode(codec, args.size, args.iterations, args.batch)
    else:
        run = bench_decode(
            codec, args.size, args.iterations, args.batch, args.erasures,
            args.erasures_generation == "exhaustive")
    # the reference's output contract (:188, :326)
    print(f"{run.elapsed:.6f}\t{run.kib}")
    if args.verbose:
        print(f"# {run.kib / 1024 / max(run.elapsed, 1e-9):.1f} MB/s "
              f"{args.plugin} {profile}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
