#!/usr/bin/env python3
"""chip_smoke.py — drive the port's flagship path on one CUDA card.

    python3 chip_smoke.py

Runs ceph_tpu_torch (never JAX, never ceph_tpu) at the bench's full size:

  1. card    nvidia-smi name and power limit, torch's device name
  2. build   nvcc builds csrc/*.cu for sm_90a, one process per source (timed);
             each kernel's registers, the straw2 item loops' SASS per item
             by pipe and gf_matvec's instructions per byte column
             (tools.sass_report, where cuobjdump is found): none of the three
             straw2 kernels (root, filter, leaf) calls a 64-bit divide or a
             device function per item, and the consume kernel's unrolled
             instances (numrep 1..8) keep their selections in registers (no
             local memory)
  3. main    with every launch count at 0: EC encode of 2048 stripes x k=8 x
             4 KiB, recovery of erasures [1, 9], a mixed-pattern decode, and
             CRUSH placement of 65,536 PGs on a 10,000-OSD map (250 hosts x 40,
             skewed weights, 10% reweighted to 0.5, 2% out), chooseleaf
             firstn 3; then the counts are read
  4. checks  every kernel equals its plain torch version on the same card
             inputs, byte for byte (the tolerance is exact equality: all of it
             is integer arithmetic); parity and decode equal the numpy oracle
             on a sample; recovery and decode rebuild the erased chunks;
             placements equal the scalar oracle crush_do_rule on 256 PGs.
             GF is also held at t = 1, 2, 3, 4, 5, 8 outputs x k = 2, 4, 8, 10
             inputs x B = 1, 15, 17, 4,096 bytes with 3 mixed patterns, on a
             data pointer one byte off, and at more stripes than the grid's
             1,024.  Both root kernels (exact and filter) and the leaf are
             also held at the small launches, where each (x, r) takes a group
             of G lanes (N = 1, 37, 1,928 and 4,096 at R = 9): the roots on
             roots of S = 1, 3 and 5 items and on a root whose weights include
             0, 1, 0xFFFF and 2^32-1; the leaf in the flagship's 40-item rows
             (and the wide map's 10-item rows in phase 5) and in host rows
             holding those weights and a row of zeros, with root positions
             -1 and NONE among the winners.  The consume kernel, which
             decides is_out itself, is held over every lane and bit against
             its plain version (is_out in torch, then the same ladder) at the
             stage-1 columns, at the stage-2 launch (the run's overflowing
             lanes first, 4,096 x 9 columns), at numrep 1..9 and 12 (every
             unrolled instance and the generic one), and on adversarial
             reweights (all 0, all 0x10000, all 0xFFFF, above 0x10000 and
             negative, random partial) and columns holding ids -1, the
             reweight vector's length and NONE
  5. wide    with every launch count at 0 again: tools.crush_test.run_test on
             a 10,000-OSD map of 1,000 hosts x 10 (the same skew and
             reweights; the root is the approx filter's width), chooseleaf
             firstn 3 on 65,536 PGs, the EC rule (chooseleaf indep, num_rep
             12) on 4,096 PGs, and a flat 1,024-OSD map on 4,096 PGs; then
             the counts are read.  Checks: placements equal the plain torch
             path and the scalar oracle on a sample; the filter kernel's
             positions, ids and flags equal its plain version exactly, and
             the exact root where its flag is 0, also at the small launches
             and on roots of 1,000 and 1,024 items; the consume kernel
             against its plain version on the wide map's firstn and flat
             columns; the ln table kernel's own bound D equals the torch
             reduction over its table exactly and the value 771,751,936, and
             the table equals torch.log2 within LN_TOL; a huge bound D flags
             every x and the fast path falls back to the exact root and
             still matches
  6. times   CUDA events, warm, median of 7: encode/recover MB/s, CRUSH Mpps;
             a torch.profiler window over the flagship CRUSH call (device busy
             share, kernels by device time); each kernel's ms by graph replay
             (its launches captured once into a CUDA graph: the card's time,
             not the host's launch rate; at or above its bound) beside
             host_ms (the same launches issued one by one from Python, timed
             in turns with the replays), its plain version and its bound
             (and,
             for the straw2 kernels, the integer-pipe floor: ALU instructions
             per item from phase 2 x items / (64 lanes x SMs x clock)); the
             three straw2 kernels also at the stage-2 launch (STAGE2_CAP x 9
             columns) with the lane group G each launch used, and over every G
             there; GF at the encode, the recovery and the mixed decode, and
             the encode on all-zero data (no shared-memory bank conflicts);
             the filter beside the exact root kernel on the same columns; the
             consume kernel at the stage-2 launch and over its block sizes.
             Beside the CRUSH rate, the one-core yardstick c_crush_mpps
             (bench.py's): native.CrushBaseline, the scalar C crush_do_rule,
             on the flagship map and rule, the first 8,192 of the same xs
             and the same reweight after a 256-x warm call, with the host
             CPU's model name (a rate of one host core, not of the card) and
             the card's ratio to it; its rows == FastMapper's on the card
  7. ec      with every launch count at 0 again: the erasure-code plugin
             layer on the card (ceph_tpu_torch.ec, runtime cuda): the 14
             corpus profiles of tools.ec_non_regression encoded and compared
             byte for byte with tests/golden/ec_corpus, and every pattern of
             up to m erasures the code recovers decoded back; then
             tools.ec_benchmark's bench_encode/bench_decode at EC_BENCH's
             shapes (BASELINE.json's configurations and two bitmatrix codes
             whose tables are cut to fit shared memory), 16 sampled stripes
             of each against the numpy oracle; then the counts are read.  At
             each shape, gf_matvec's launches of one call are held against
             the plain version on the card and timed by graph replay beside
             their bound, with the codec's call on card data and the native C
             encode (ceph_tpu_torch.native) on the same host data.  Last, a
             fast-path rule of 65 replicas runs on the card with the counts
             reset, launches the consume kernel's generic instance and equals
             crush_do_rule, and that kernel is held against its plain version
             on the rule's columns at R = numrep + 1 and tries + numrep.
             It runs after the times, so
             that phase 6 times the flagship calls in the same process state
             as the runs before this phase existed
  8. engine  default_context()'s dispatch engines on the card at the knobs'
             defaults (max_stripes 2048, max_delay_us 250, depth 2), the
             OSD's EC write and read at the flagship profile from 16
             submitter threads (Ceph's SSD op queue: 8 shards x 2 threads),
             each with the launch counts at 0 first: (a) submit_chunks of
             256 MiB of isa cauchy k=8 m=4 data in requests of 1-64
             stripes of 4 KiB chunks; (b) submit_decode_chunks of the same
             bytes mixing erasure patterns [1, 9], [0, 3] and [11]; (c)
             crush_test --osds 1024 on 65,536 PGs (submit_flat_firstn, in
             chunks of max_stripes); (d) submit_do_rule on the flagship
             10k-OSD map, chooseleaf firstn 3, 65,536 PGs in requests of
             256-2,048.  Each: every delivered row against one direct call
             per request from one thread, a sample against the numpy oracle
             (ec_encode_ref, the recovery matrix, flat_firstn_ref,
             crush_do_rule), the kernels' launches against the engine's
             calls, fault_digest() zero; then a timed run (host clock, first
             submit to last delivery) with its phase ledger (calls, stripes a
             call, buckets, padding, phase medians) and a torch.profiler
             run (the card's busy share), beside the direct calls' rate.
             (e) the ladder armed on purpose: dispatch.block_until_ready
             fails once (one retry, bit-exact), then always (the breaker
             opens after kernel_fault_breaker_threshold batches of
             kernel_fault_max_retries retries; the host oracle serves
             bit-exact), is disarmed, and the probe re-closes the breaker;
             the exact counts are held
  9. mapping the OSDMap and the context's shared PG mapping service on the
             card (a fresh CephTpuContext at the knobs' defaults), the fault
             and mapping counters first set to 0: bench_map's 10,000 OSDs
             (its reweights as osd_weight, every OSD up), pool 1 replicated
             size 3 on the chooseleaf firstn host rule and pool 2 erasure
             k=8 m=4 (size 12) on a chooseleaf indep host rule, pg_num
             262,144 and 16,384 (Ceph's mon_target_pg_per_osd 100: OSDs x
             100 / size to a power of two; 983,040 PG replicas), through
             four epochs, each a new map passed to update_to with the
             launch counts at 0 just before it and read just after: e1 the
             base map (every pool built; the straw2 kernels and
             pg_finish_ladder launch); e2 overrides only (1,024
             pg_upmap_items on pool 1 and 64 on pool 2 with 1-3 pairs, some
             invalid or with a NONE frm; 256 pg_upmap rows, some naming an
             out OSD; 512 pg_temp, some empty; 128 primary_temp; primary
             affinity 0x8000 on 5% of OSDs and 0 on 1%): the raw tables
             are reused and no straw2 kernel launches; e3 100 OSDs down,
             one whole host among them; e4 1% reweighted to 0x8000 and 20
             out (both pools remap through submit_do_rule).  Each pool's
             tail runs at the pool's own width (pool 1 W = 3, pool 2 W =
             12).  At every epoch: each pool's packed table == the numpy
             ladder_ref over all rows and the kernel == ladder_plain on the
             card on the same operands, and the service's card copy == its
             host copy; pg_finish_ladder launched once a pool whose tail
             re-ran (counted by (W, P, erasure)), pg_osd_words once; no
             packed table uploaded for the diff; in e1 and e4 each pool's
             remap batch on the engine (launch and compute ms: pool 1's
             fast path, pool 2's chooseleaf indep interpreter); lookup ==
             pg_to_up_acting_osds (the scalar oracle, in worker processes)
             on every PG an override names and a seeded 1,024 PGs of pool 1
             and 256 of pool 2; the delta == the rows where the two epochs'
             packed tables differ; no full rescan after e1; MappingStats'
             unfused_epochs and lookup_fallbacks 0; fault_digest() zero.
             Then what_if_up against the host pipeline, e4's content again
             with osdmap_mapping_fused off (host-tail lookups == the fused
             rows), osdmap_test.test_map_pgs on e4's map and psim on the
             250 x 40 map, the kernel and pg_osd_words against their plain
             versions and ladder_ref on adversarial operands (W 1..32; P 1,
             2, 4; N 1, 37, 203; a pad row in the middle; maps of 10,000 and
             60,000 OSDs on 51,277 rows, the last tile ragged), and each
             pool's kernel at its e4 shape by graph replay beside host_ms,
             ladder_plain's time, its bound, its launches, the host's
             build_operands time and the MB and padding its tail moves;
             then pool 1 at the one width both pools shared before (W = 12)
             with the first version of the kernel (ab_kernels.py,
             ab_ladder.cu), beside this kernel, in turns
 10. cluster the OSD data path on a MiniCluster on the card (every daemon's
             context on it): 12 OSDs on memstore over the loopback
             messenger, 1 mon, an erasure pool jerasure reed_sol_van k=8
             m=4 (chooseleaf indep over the flat root, stripe_unit 4,096,
             pg_num 128: Ceph's documented defaults), the pool's PGs
             active first; then rados bench's traffic (4 MiB objects, 16
             in flight through aio_write_full/aio_read), each sub-phase
             with the launch counts at 0 just before it and read just
             after: 10a writes 256 objects, 10b reads them back, 10c
             kills an OSD, marks it down and reads everything again
             (degraded reads through the decode channel), 10d starts a
             new OSD, marks the dead one out and waits until every
             object's 12 shards sit with a matching hinfo on the OSDs the
             new map names, then reads everything once more.  Each prints
             MB/s by the host clock, gf_matvec launches, the OSDs' summed
             EC counters and the engines' phase ledgers.  Checks: every
             read equals the bytes written; gf_matvec launched in 10a, 10c
             and 10d, ec_decode_submits > 0 in 10c; 8 sampled objects'
             shards == the numpy oracle's encode with matching hinfo (after
             10a and 10d); gf_matvec == its plain version on one object's
             (128, 8, 4096) stripes; every context's fault_digest() zero;
             no engine thread alive after stop() (the threads and
             torch.cuda.memory_allocated() printed).  10e, after phase 11
             (every shard on the OSDs the map names): rados bench, the
             port's tools.rados_bench.ObjBencher on the same pool at 4 MiB
             objects, 16 in flight, run name bench10e: write_bench(5 s), then
             seq_read_bench(3 s) and rand_read_bench(3 s) over what it wrote,
             each with the launch counts at 0 just before it and read just
             after, each result printed with its MB/s beside 10a's and 10b's.
             Checks: errors 0 and ops > 0 in each; gf_matvec launched by the
             write; 8 of its objects drawn with a seed read back == the bench
             payload, their shards on the OSDs the map names == their
             stripes and gf_matvec's plain version on the card, hinfo
             matching; every context's fault_digest() zero.  The objects
             stay (an EC pool takes no delete).  10e's seconds are printed
             apart from phase 10's.  The card's busy share over degraded
             reads of 32 objects, from torch.profiler
 11. scrub   deep scrub on phase 10's cluster before it stops (after 10d,
             12 OSDs up): a replicated pool at the defaults (size 3, pg_num
             32) takes 16 rados bench objects of 4 MiB; then three passes
             of scrub_all_pgs on every OSD at once, each with the launch
             counts at 0 just before it and read just after: 11a clean
             (every PG of both pools, every peer reporting; the card's busy
             share from torch.profiler), 11b after one replica's object and
             one EC shard are corrupted at the store (exactly those two
             found inconsistent, repaired — the shard rebuilt through
             gf_matvec — and verified, the stores holding the original
             bytes again), 11c clean again.  Each pass prints its MB read
             and digested per second by the host clock and its launches;
             checks: every scrub_digest batch == the plain version on the
             card and its crc column == zlib.crc32 of each unpadded row on
             the host, the rows digested on the card == the rows the scrubs
             read, no host-loop batch, every context's fault_digest() zero.
             Then the kernel alone at DIGEST_SHAPES: a 16-object chunk of
             each pool (32 rows of 4 MiB and of 512 KiB, half of them omap
             rows under 64 bytes, with their lengths), the first with every
             row full, and BlueStore's 1,024 blocks of 4 KiB; each held
             against the plain version on the card, timed by graph replay
             beside the launches issued from Python, beside two bounds (the
             padded rows' bytes, and the bytes the lengths need: each row
             up to its length, in 32-byte sectors) and at or above the
             second, with the plain version's time; the phase's seconds
             (budget 90)
 12. bluestore  BlueStore on the card, after phase 10's cluster stops.
             12a: one BlueStoreLite on a context on the card, in a temporary
             directory, compression aggressive with tpu_bitplane at the
             required ratio 0.875; 64 objects of 4 MiB made from a seed (a
             third 7-bit ASCII text, a third small integers four fifths
             zero, a third random) written in transactions of 4, read back
             (each read's 1,024 blocks verified in one bluestore_data
             digest), the store unmounted and mounted and everything read
             again, then one bit of one stored block flipped in the block
             file: its read raises IOError and csum_errors is 1.  Each
             sub-step starts with the launch counts at 0 and prints MB/s by
             the host clock, bitplane_pack and scrub_digest launches and
             the store's counters; the write prints the stored bytes over
             the logical bytes.  Checks: every bitplane_pack batch == the
             plain version on the card, every bluestore_data batch == the
             plain version and its crc column == zlib.crc32 of each stored
             payload on the host, csum_scalar_blocks and csum_fallbacks 0,
             every read == the bytes written, fault_digest() zero.  12b: a
             MiniCluster of 6 OSDs on store_type="bluestore" (1 mon,
             loopback), one EC pool jerasure reed_sol_van k=4 m=2, stripe
             unit 4 KiB, pg_num 16, compression aggressive tpu_bitplane
             (`osd pool set`); 16 objects of 4 MiB, 16 in flight: write,
             read, one OSD killed and marked down and every object read
             degraded (the card's busy share from torch.profiler), the OSD
             restarted on its own path (its store remounts and replays its
             KV journal) until every object's 6 shards sit with matching
             hinfo, one scrub_all_pgs pass on every OSD at once, clean.
             Each sub-step prints MB/s and its gf_matvec, scrub_digest and
             bitplane_pack launches and batched against scalar csum blocks
             (commits on an engine's own thread are scalar by design).
             Checks: csum_batches > 0, every read == the bytes written,
             every batch == its plain version as in 12a, fault_digest()
             zero, no engine thread alive after stop().  Then
             bitplane_pack alone: its registers, spills and SASS calls
             (no 64-bit divide), a ragged (37, 4,104) call on a data
             pointer one byte off alignment, and (1,024, 4,096) and (256,
             4,096) random bytes, cold (inputs in turn over 64 MiB) and
             warm, and one of 12a's batches, held against the plain
             version, timed by graph replay and issued, beside its bound
             (each input byte read once, each plane byte written once) and
             the plain version's time; the phase's seconds (budget 120)
 13. mgr     the manager on the card, after phase 12.  13a: a MiniCluster of
             6 OSDs on memstore over loopback, 1 mon, mgr.0 and mgr.1 started
             before the OSDs (every context on the card; the mgrs' contexts
             with osdmap_mapping_min_pgs 64, so that their mapping service
             places the pools below on the card); a replicated pool of size 3
             and pg_num 256 and an erasure pool jerasure reed_sol_van k=4 m=2
             (stripe unit 4 KiB) of pg_num 64 (OSDs x 100 / size to a power
             of two, under mon_max_pg_per_osd 250); then sub-steps, each with
             the launch counts at 0 just before it and read just after: (1)
             16 rados bench objects of 4 MiB into each pool, 16 in flight,
             iostat polled through client.mgr_command meanwhile; (2) pg
             dump, df and iostat through mgr_command once the reports have
             landed; (3) the Prometheus scrape of serve_prometheus(0) over
             HTTP on 127.0.0.1; (4) balancer optimize through mgr_command,
             its commands sent to the mon, which makes new epochs; (5) osd
             reweight-by-utilization on the mon; (6) mgr.0 killed, mgr.1
             promoted and answering pg dump; (7) every object read back.
             Checks: pg dump's rows == each primary OSD's own PG (state, up,
             log head and size); df counts every replica and shard the map
             places; iostat showed writes; the scrape parses, its gf_matvec
             launches equal the count since the reset and the EC engines'
             ec_encode + ec_decode calls equal the writes' gf_matvec
             launches; balancer optimize launched pg_finish_ladder for its
             what_if_up batches, every batch == ladder_plain on the card on
             the same operands, the plan == the plan on the same map with
             osdmap_mapping_fused off on the mgr's context, command for
             command, and neither pool's (min, max) PGs an OSD is wider
             after the upmap epochs; every read == the bytes written;
             HEALTH_OK from the mon and mgr.1; every context's
             fault_digest() zero; no engine thread alive after stop().
             13b: the balancer at full width on phase 9's map at e4 in
             phase 9's context's mapping service: calc_pg_upmaps at its
             defaults (max_deviation 1, max_optimizations 256) for pool 1
             (replicated size 3, 262,144 PGs, W = 3), then pool 2 (k=8 m=4
             chooseleaf indep, 16,384 PGs, W = 12); each prints its seconds
             split into the histogram, the what_if_up calls and the host
             loop, pg_finish_ladder's launches and candidates a launch, the
             kernel at the median what-if batch by graph replay beside its
             bound and ladder_plain's time, and its changes; checks: every
             what_if_up batch == ladder_plain on the card, the plan == the
             same call with osdmap_mapping_fused off (every score from up_of
             on the host); then both plans applied as a new epoch
             (update_to), neither pool's spread wider, a seeded 256 of the
             moved PGs' up/acting == the scalar oracle in worker processes,
             fault_digest() zero; the phase's seconds (budget 120)
 14. tcp     the daemons over TCP with cephx, and as OS processes, after
             phase 13.  14a: phase 10's cluster (12 OSDs, the EC pool
             jerasure reed_sol_van k=8 m=4 of 128 PGs, 64 rados bench
             objects of 4 MiB, 16 in flight) on the event TCP stack
             (ms_type "async") with cephx (MiniCluster(cephx=True): every
             daemon's key provisioned, tickets on every data-path
             connection), on BlueStore; writes, reads, one OSD killed and
             marked down, degraded reads, each with the launch counts at 0
             just before it and read just after, its MB/s printed beside
             phase 10's on loopback.  Checks: every daemon on the event
             stack with its cephx config, the mon's sessions carrying the
             OSDs' and the client's identities; every read == the bytes
             written; CLUSTER_SAMPLE objects' shards on the OSDs the map
             names == their stripes and gf_matvec's plain version on the
             card, hinfo matching; gf_matvec and scrub_digest launched by
             the writes, gf_matvec by the degraded reads; every context's
             fault_digest() zero.  14b: ProcCluster(device="cuda"): a mon
             and 6 OSD processes (python -m ceph_tpu_torch.tools.daemon_main,
             FileStore, spawned together), an EC pool k=4 m=2 of 16 PGs;
             32 objects of 4 MiB written and read back, osd.1 killed by
             SIGKILL and marked down, 8 more written, all 40 read, osd.1
             restarted on its store until the mon reports HEALTH_OK for 2
             s; each process's seconds from spawn to ready, the card's
             memory (nvidia-smi's compute apps, and cudaMemGetInfo's growth
             over the spawn), the restart-to-recovered seconds; after
             stop() each OSD's FileStore is opened here and every object's
             6 shards on the OSDs the map names are held against their
             stripes and gf_matvec's plain version on the card, hinfo
             matching.  After HEALTH_OK and before stop(), rados bench's
             CLI (python -m ceph_tpu_torch.tools.rados_bench, a process of
             its own on the card) against the mon: 3 s of writes, 16 in
             flight, then seq over the objects they wrote; each JSON line
             parsed and printed, exit code 0 and errors 0.  The OSDs'
             MMgrReport perf payload carries their encode submits, not the
             encode channel's calls, so no mgr is spawned; the kernels of
             14b launch in the OSD processes and are not counted.  The
             phase's seconds (budget 120)
 15. prints  the {"crush_baseline": ...} line (phase 6's one-core C rate),
             the {"engine": ...} line, the {"mapping": ...} line, the
             {"cluster": ...} line, the {"scrub": ...} line, the
             {"bluestore": ...} line, the {"mgr": ...} line, the {"tcp":
             ...} line, the {"kernels": [...]} line (gf_matvec's row also
             carries the EC shapes of phase 7 as "ec_shapes", its launches
             by cluster sub-phase (10e's write, seq and rand included) as
             "cluster" and by phase 14a's sub-step
             as "tcp"; pg_finish_ladder's its launches per
             epoch, each pool's shape and times, the first version's times,
             its balancer launches by phase 13 sub-step and pool as
             "manager_launches" and its time at each pool's median what-if
             batch as "what_if"; pg_osd_words's its launches per epoch;
             scrub_digest's its bluestore_data launches by phase 12's
             sub-step and by 14a's as "tcp_bluestore_data_launches";
             bitplane_pack's its launches by sub-step), then
             {"ok": true, "device": ...}

Exits non-zero, printing no result, without a card or without the package.
"""

from __future__ import annotations

import gc
import io
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and the
#: non-tensor 32-bit rate, used for 32-bit integer work (the card runs
#: 32-bit integer operations at no more than this rate)
PEAK_BYTES_S = 3.35e12
PEAK_OPS32_S = 67e12
#: 32-bit integer operations of one straw2 draw: rjenkins hash32_3 (5 mixes
#: of 36 operations plus 3 seed XORs = 183), crush_ln (~12), mask, divide,
#: compare (~5)
OPS_PER_DRAW = 200

#: 32-bit integer lanes per SM (Hopper: 16 a scheduler) for the
#: integer-pipe floor of the straw2 kernels
INT_LANES_PER_SM = 64

#: f32 operations of the approx filter's band per item, beside its hash32_3
#: (183): mask, convert, +1, log2, scale, 2^48 - ln, divide, margin (multiply,
#: two adds), the two band ends, the running minimum and the insertion test
FILTER_OPS_PER_ITEM = 183 + 14
#: operations per entry of the ln table kernel: the f32 table (convert, add,
#: log2, scale), the exact crush_ln (~12), its rounding to f32, the gap
#: (subtract, abs) and the running maximum
LN_OPS = 4 + 12 + 4
#: 32-bit integer operations of the consume kernel's is_out hash: hash32_2
#: (3 mixes of 36 operations plus 2 seed XORs), its mask and the compare
HASH2_OPS = 3 * 36 + 2 + 2
#: the certificate's bound D on the H100 (every run since the filter's
#: first, and the JAX package's value)
LN_BOUND_D = 771751936.0
#: ln_f32_table against torch.log2 on the card: two f32 ulps at the top of
#: the range (2^48).  Both are full-precision log2f, so they agree to the
#: last bit or nearly; the filter's certificate rests on the kernel's own
#: table either way
LN_TOL = 2.0 ** 26

K, M, CHUNK, STRIPES = 8, 4, 4096, 2048
ERASURES = [1, K + 1]
DECODE_PATTERNS = [[1, 9], [0, 3], [5, 11]]
N_PGS, NUMREP, N_OSDS = 65536, 3, 10000
ORACLE_PGS = 256
#: the kernels of the flagship main path (the wide-map path has its own)
MAIN_KERNELS = ("gf_matvec", "straw2_root", "straw2_leaf", "firstn_consume")
#: the wide-map path: crush_test on 1,000 hosts x 10 OSDs (root padded to
#: 1024: the approx filter's range), then the EC rule (chooseleaf indep,
#: num_rep 12) and a flat 1024-OSD map, each on fewer PGs
WIDE_HOSTS, WIDE_PER_HOST = 1000, 10
EC_PGS, EC_NUMREP, FLAT_OSDS, FLAT_PGS = 4096, 12, 1024, 4096
#: scalar-oracle samples (~0.1 s a PG on a 1,000-item root), and the
#: interpreter's CPU comparison
WIDE_ORACLE, SMALL_ORACLE, EC_CPU_PGS = 64, 32, 128
#: batch sizes of the root kernels' small launches: one x, a ragged few,
#: the flagship's stage-2 lanes and the stage-2 capacity (the launch)
SMALL_NS = (1, 37, 1928, 4096)
#: the EC codec phase's ec_benchmark runs at full width: (label, plugin,
#: profile, --size, --batch, workload, --erasures).  BASELINE.json's
#: configurations (isa cauchy k=8 m=4 over 4 KiB chunks, encode and 2-erasure
#: decode; isa k=10 m=4 on a 64 KiB stripe, 1,024 objects; jerasure
#: reed_sol_van k=4 m=2 on 4 KiB objects), and two bitmatrix codes whose
#: packed tables exceed the kernel's shared memory and are cut (blaum_roth
#: k=7 at its w=10, 350 KiB; liberation k=8 w=11, 528 KiB)
EC_BENCH = [
    ("isa cauchy k=8 m=4 encode", "isa",
     {"k": "8", "m": "4", "technique": "cauchy"}, 32768, 2048, "encode", 0),
    ("isa cauchy k=8 m=4 decode, 2 erased", "isa",
     {"k": "8", "m": "4", "technique": "cauchy"}, 32768, 2048, "decode", 2),
    ("isa cauchy k=10 m=4 encode", "isa",
     {"k": "10", "m": "4", "technique": "cauchy"}, 65536, 1024, "encode", 0),
    ("jerasure reed_sol_van k=4 m=2 encode", "jerasure",
     {"k": "4", "m": "2", "technique": "reed_sol_van"}, 4096, 8192, "encode",
     0),
    ("jerasure blaum_roth k=7 encode", "jerasure",
     {"k": "7", "technique": "blaum_roth"}, 32768, 2048, "encode", 0),
    ("jerasure blaum_roth k=7 decode, 2 erased", "jerasure",
     {"k": "7", "technique": "blaum_roth"}, 32768, 2048, "decode", 2),
    ("jerasure liberation k=8 w=11 encode", "jerasure",
     {"k": "8", "w": "11", "technique": "liberation"}, 32768, 2048, "encode",
     0),
]
#: calls of each ec_benchmark run (--iterations = EC_CALLS x --batch)
EC_CALLS = 5
#: a fast-path rule of more replicas than the consume kernel unrolls (its
#: generic instance): flat OSDs, replicas, PGs held against the oracle
WIDE_NUMREP_OSDS, WIDE_NUMREP, WIDE_NUMREP_PGS = 256, 65, 64


#: the engine phase (8): the OSD's EC write and degraded read at the
#: flagship profile through default_context()'s engines at the knobs'
#: defaults, from Ceph's SSD op-queue threads (osd_op_num_shards_ssd 8 x
#: osd_op_num_threads_per_shard_ssd 2); 256 MiB of data a channel in
#: requests of 1-64 stripes; remaps of 65,536 PGs
ENGINE_THREADS = 16
ENGINE_STRIPES = 8192                 # 8192 x 8 x 4 KiB = 256 MiB
ENGINE_MAX_REQ = 64
ENGINE_PATTERNS = [(1, 9), (0, 3), (11,)]
ENGINE_RULE_REQ = (256, 2048)         # PGs a submit_do_rule request
ENGINE_ORACLE = 16                    # requests sampled against the oracle
ENGINE_RULE_ORACLE = 4                # PGs of each against crush_do_rule
NONE_ID = 0x7FFFFFFF

#: the mapping phase (9): osdmaptool --test-map-pgs scale on the flagship
#: 10,000-OSD map at Ceph's mon_target_pg_per_osd 100 (nautilus): pg_num =
#: OSDs x 100 / size, to a power of two — a replicated size-3 pool on the
#: map's chooseleaf firstn host rule and an erasure k=8 m=4 pool on a
#: chooseleaf indep host rule; 983,040 PG replicas, ~98 per OSD
MAP_REP_PGS, MAP_EC_PGS, MAP_EC_SIZE = 262144, 16384, 12
#: e2's overrides: pg_upmap_items on pool 1 and pool 2, pg_upmap rows,
#: pg_temp entries (pool 1, pool 2) and primary_temp (pool 1, pool 2)
MAP_ITEMS, MAP_EC_ITEMS, MAP_UPMAP = 1024, 64, 256
MAP_TEMP, MAP_EC_TEMP, MAP_PTEMP, MAP_EC_PTEMP = 448, 64, 112, 16
#: seeded PGs of each pool held against the scalar oracle at every epoch,
#: beside every PG an override names
MAP_SAMPLE = {1: 1024, 2: 256}
#: the adversarial kernel checks: widths, pairs, row counts
LADDER_WIDTHS, LADDER_PAIRS, LADDER_NS = tuple(range(1, 33)), (1, 2, 4), \
    (1, 37, 203)
#: rows of the cases over many tiles a block: not a multiple of the tile
#: (128 rows), so the last tile is ragged
LADDER_BIG_N = 128 * 400 + 77

#: the cluster phase (10): a MiniCluster at Ceph's documented defaults —
#: 12 OSDs on memstore over the loopback messenger, 1 mon, an erasure pool
#: jerasure reed_sol_van k=8 m=4 whose rule is chooseleaf indep over the
#: flat root (failure domain: the OSD), stripe_unit 4,096 B
#: (osd_pool_erasure_code_stripe_unit), pg_num 128 (nautilus's
#: mon_target_pg_per_osd 100: 12 x 100 / 12 to a power of two); traffic
#: at rados bench's defaults: 4 MiB objects, 16 ops in flight
CLUSTER_OSDS, CLUSTER_K, CLUSTER_M, CLUSTER_PG_NUM = 12, 8, 4, 128
CLUSTER_STRIPE_UNIT = 4096
CLUSTER_OBJ_BYTES = 4 << 20
#: rados bench's run is 256 such objects here (1 GiB); at 256 the phase
#: passed its budget on the H100 (10d still had 634 of 3,072 shards to
#: place after 300 s), so it runs CLUSTER_OBJECTS and prints the cut
CLUSTER_FULL_OBJECTS = 256
CLUSTER_OBJECTS = 64
CLUSTER_IN_FLIGHT = 16
CLUSTER_SAMPLE = 8                   # objects held against the oracle
CLUSTER_VICTIM = 5                   # the OSD 10c kills and 10d outs
CLUSTER_BUSY_OBJECTS = 32            # degraded reads under the profiler
CLUSTER_OP_TIMEOUT = 300.0
CLUSTER_RECOVERY_S = 300.0
CLUSTER_BUDGET_S = 120.0
#: 10e, rados bench on phase 10's cluster (the port's ObjBencher): seconds of
#: writes, then of sequential and of random reads of what they wrote
BENCH_RUN_NAME = "bench10e"
BENCH_WRITE_S = 5.0
BENCH_READ_S = 3.0
#: the one-core C CRUSH yardstick (bench.py's c_crush_mpps): PGs, warm PGs
C_CRUSH_PGS = 8192
C_CRUSH_WARM = 256
# phase 11: deep scrub on phase 10's cluster, plus a replicated pool at the
# defaults osd_pool_default_size 3 and osd_pool_default_pg_num 32, holding
# rados bench objects; a scrub chunk is osd_scrub_chunk_objects (16)
SCRUB_REP_SIZE, SCRUB_REP_PG_NUM, SCRUB_REP_OBJECTS = 3, 32, 16
SCRUB_CHUNK_OBJECTS = 16
SCRUB_BUDGET_S = 90.0
#: scrub_digest alone, at phase 11's two batch shapes (a 16-object chunk of
#: each pool: half the rows data, half omap rows under 64 bytes, zero
#: padded to the data width), at the first with every row full, and at
#: BlueStore's 4 KiB blocks: (label, rows, width, half omap)
DIGEST_SHAPES = (("(32, 2^22) half omap", 32, 1 << 22, True),
                 ("(32, 2^19) half omap", 32, 1 << 19, True),
                 ("(32, 2^22) full rows", 32, 1 << 22, False),
                 ("(1024, 4096) full rows", 1024, 4096, False))

# phase 12: BlueStore on the card.  12a: one store, rados bench's 4 MiB
# objects in transactions of 4, compression aggressive with tpu_bitplane at
# the default required ratio; 12b: a 6-OSD MiniCluster on BlueStore, one
# EC pool k=4 m=2 (stripe unit 4 KiB) of 16 PGs, compression aggressive
BS_OBJECTS, BS_OBJ_BYTES, BS_TXN_OBJECTS = 64, 4 << 20, 4
BS_RATIO = 0.875
BS_CLUSTER_OSDS, BS_K, BS_M, BS_PG_NUM = 6, 4, 2, 16
BS_CLUSTER_OBJECTS = 16
BS_VICTIM = 2                        # the OSD 12b kills and restarts
BS_BUDGET_S = 120.0
#: bitplane_pack alone: BlueStore's 4 MiB write (1,024 blocks of 4 KiB) and
#: a 12b shard write of 1 MiB (256 blocks), each cold (inputs and outputs in
#: turn over PACK_COLD_BYTES, past the 50 MB L2) and warm; and a ragged
#: (S, W) on a data pointer PACK_RAGGED[2] bytes past a 16-byte boundary
PACK_SHAPES = ((1024, 4096), (256, 4096))
PACK_COLD_BYTES = 64 << 20
PACK_RAGGED = (37, 4104, 1)

# phase 13: the manager.  13a: a MiniCluster of 6 OSDs (memstore, loopback,
# 1 mon) with mgr.0 and mgr.1 started before the OSDs; a replicated pool of
# size 3 and an erasure pool jerasure reed_sol_van k=4 m=2 (stripe unit
# 4 KiB) at mon_target_pg_per_osd 100: 6 x 100 / 3 = 200 -> 256 PGs, and
# 6 x 100 / 6 = 100 -> 64 (128 would put 256 PG replicas on an OSD, past
# mon_max_pg_per_osd 250; these put 192); rados bench's 4 MiB objects, 16
# a pool, 16 in flight.  The mgrs' contexts map pools of MGR_MIN_PGS PGs or
# more on the card (osdmap_mapping_min_pgs).  13b: calc_pg_upmaps at its
# defaults on phase 9's map at e4, and MGR_ORACLE moved PGs against the
# scalar oracle
MGR_OSDS, MGR_REP_PGS, MGR_EC_PGS, MGR_K, MGR_M = 6, 256, 64, 4, 2
MGR_OBJECTS, MGR_OBJ_BYTES = 16, 4 << 20
MGR_MIN_PGS = 64
MGR_ORACLE = 256
MGR_BUDGET_S = 120.0
# phase 14: the daemons over TCP.  14a: phase 10's cluster (12 OSDs, the EC
# pool k=8 m=4 of 128 PGs, rados bench's 4 MiB objects, 16 in flight) on
# the event TCP stack with cephx, on BlueStore; 14b: the daemons as OS
# processes (ProcCluster): a mon and 6 OSDs on FileStore, an EC pool
# jerasure reed_sol_van k=4 m=2 (stripe unit 4 KiB) of 16 PGs, 32 objects,
# then 8 more with osd.1 killed
TCP_OBJECTS = 64
TCP_PROC_OSDS, TCP_PROC_K, TCP_PROC_M, TCP_PROC_PG_NUM = 6, 4, 2, 16
TCP_PROC_OBJECTS, TCP_PROC_MORE = 32, 8
TCP_PROC_VICTIM = 1
TCP_BUDGET_S = 120.0
#: 14b's rados bench CLI against the processes: seconds of writes and reads
TCP_CLI_S = 3.0


def digest_batch(dev, rng, s: int, w: int, omap: bool) -> dict:
    """A scrub_digest batch on ``dev``: s rows of width w, the second half
    omap rows of 0-63 bytes when ``omap`` (else every row full), random
    bytes up to each length and zeros past it; its lengths (int32, on the
    card and on the host) and unpad operands."""
    import numpy as np
    import torch

    from ceph_tpu_torch.ops import checksum_kernel as ck
    lens = np.full(s, w, dtype=np.int32)
    if omap:
        lens[s // 2:] = rng.integers(0, 64, s - s // 2)
    data = torch.from_numpy(rng.integers(0, 256, (s, w), dtype=np.uint8)
                            ).to(dev)
    col = torch.arange(w, device=dev)[None, :]
    data *= (col < torch.from_numpy(lens).to(dev)[:, None]).to(torch.uint8)
    mats, invp = ck.digest_operands(lens, w)
    return {"data": data, "lens": torch.from_numpy(lens).to(dev),
            "lens_np": lens, "mats": torch.from_numpy(mats).to(dev),
            "invp": torch.from_numpy(invp).to(dev)}


def rows_of(m, rid: int, xs, rw_list) -> "np.ndarray":
    """crush_do_rule's rows for ``xs``, NONE-padded to NUMREP."""
    import numpy as np
    from ceph_tpu_torch.crush.mapper_ref import crush_do_rule
    rows = [crush_do_rule(m, rid, int(x), NUMREP, rw_list) for x in xs]
    return np.array([r + [NONE_ID] * (NUMREP - len(r)) for r in rows],
                    dtype=np.int32).reshape(-1, NUMREP)



class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok  {what}")


def assert_no_faults(where: str, digest: dict | None = None) -> None:
    """The ladder must not hide the card: outside the armed sub-phase no
    retry, no fallback batch, no probe, no thread death, every breaker
    closed.  ``digest``: one context's ``fault_digest()`` (default: the
    process-wide counters)."""
    from ceph_tpu_torch.ops import telemetry
    if digest is None:
        digest = telemetry.fault_digest()
    for eng, d in digest.items():
        moved = {k: v for k, v in d.items()
                 if k != "breaker_states" and v}
        open_ = {c: s for c, s in d["breaker_states"].items()
                 if s != telemetry.BREAKER_CLOSED}
        check(not moved and not open_,
              f"{where}: {eng} engine fault digest zero, every breaker "
              f"closed ({moved or 'no counters'}, {open_ or 'no breakers'})")


def _split(rng, total: int, lo: int, hi: int) -> list[int]:
    sizes = []
    while sum(sizes) < total:
        sizes.append(min(int(rng.integers(lo, hi + 1)), total - sum(sizes)))
    return sizes


def _drive(reqs, submit) -> tuple[list, float]:
    """``reqs`` round-robin over ENGINE_THREADS submitter threads, each
    submitting its share without waiting (submit-and-continue), released
    together; returns (results in request order, seconds from the first
    submit to the last delivery)."""
    import threading
    futs = [None] * len(reqs)
    start = threading.Barrier(ENGINE_THREADS + 1)
    errs: list = []

    def worker(w):
        try:
            start.wait(60)
            for i in range(w, len(reqs), ENGINE_THREADS):
                futs[i] = submit(reqs[i])
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(ENGINE_THREADS)]
    for t in threads:
        t.start()
    start.wait(60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(300)
    if errs or any(t.is_alive() for t in threads):
        raise SmokeFailure(f"engine submitters failed: {errs}")
    out = [f.result(timeout=300) for f in futs]
    return out, time.perf_counter() - t0


def _ledger(stats) -> dict:
    """Calls, stripes per call, buckets, padding and phase medians of the
    batches the stats' phase ring recorded."""
    from ceph_tpu_torch.ops import telemetry
    recs = stats.phases.dump()["recent"]
    stripes = [r["stripes"] for r in recs]
    buckets: dict = {}
    for r in recs:
        buckets[r["bucket"]] = buckets.get(r["bucket"], 0) + 1
    hist: dict = {}
    for s in stripes:
        b = 1 << max(0, (s - 1).bit_length())
        hist[f"<={b}"] = hist.get(f"<={b}", 0) + 1
    padded = sum(r["bucket"] - r["stripes"] for r in recs)
    return {
        "calls": len(recs),
        "requests": sum(r["requests"] for r in recs),
        "stripes_per_call_mean": (statistics.mean(stripes)
                                  if stripes else 0.0),
        "stripes_per_call_hist": dict(sorted(
            hist.items(), key=lambda kv: int(kv[0][2:]))),
        "buckets": dict(sorted(buckets.items())),
        "padding_share": (padded / sum(r["bucket"] for r in recs)
                          if recs else 0.0),
        "phase_median_ms": {
            ph: statistics.median(r["phases"][ph] for r in recs) * 1e3
            for ph in telemetry.PHASES} if recs else {},
        "e2e_median_ms": (statistics.median(r["e2e_s"] for r in recs) * 1e3
                          if recs else 0.0),
    }


def _trace_spans(prof):
    """(name, is_device, start_us, end_us) of every activity of a trace:
    the raw Kineto activity list where torch exposes it (it keeps device
    events the event tree can drop), else the event tree."""
    from torch.autograd import DeviceType
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.device_type() == DeviceType.CUDA,
                 e.start_ns() / 1e3, e.end_ns() / 1e3) for e in raw]
    except AttributeError:
        return [(e.name, e.device_type == DeviceType.CUDA,
                 e.time_range.start, e.time_range.end)
                for e in prof.events()]


def _busy(run, reset, tries: int = 3) -> dict:
    """torch.profiler (CPU and CUDA activities) over one run: the card's
    busy time (the union of its kernel, copy and fill intervals) over the
    window, and the pinned copies' time by direction.  A trace is taken
    only when it holds every kernel launch the run made (a second profiler
    session in one process has dropped device events); after ``tries``
    incomplete traces the share is reported as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.ops import _build
    for _ in range(tries):
        reset()
        _build.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        launched = sum(_build.LAUNCHES.values())
        spans_all = _trace_spans(prof)
        dev_ev = [(n, a, b) for n, dev_, a, b in spans_all if dev_]
        captured = sum(1 for n, _a, _b in dev_ev
                       if any(k in n for k in _build.LAUNCHES))
        if captured == launched:
            break
    busy = _union(a_b for _n, *a_b in dev_ev)
    by_name: dict = {}
    for n, a, b in dev_ev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e3
    window = (max(b for *_x, b in spans_all)
              - min(a for *_x, a, _b in spans_all)) if spans_all else 0.0
    h2d = sum(t for n, t in by_name.items() if n.startswith("Memcpy HtoD"))
    d2h = sum(t for n, t in by_name.items() if n.startswith("Memcpy DtoH"))
    complete = captured == launched
    return {"complete": complete, "captured": captured,
            "launched": launched, "window_ms": window / 1e3,
            "busy_ms": busy / 1e3 if complete else None,
            "busy_share": busy / window if window and complete else None,
            "h2d_ms": h2d if complete else None,
            "d2h_ms": d2h if complete else None,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}


def engine_phase(dev, tag: str, xs_np) -> dict:
    """Phase 8: the dispatch engine carrying the EC encode, EC decode and
    CRUSH channels (see the module docstring)."""
    import numpy as np
    import torch

    from ceph_tpu_torch.common import failpoint
    from ceph_tpu_torch.common.context import default_context
    from ceph_tpu_torch.crush.builder import build_flat_map
    from ceph_tpu_torch.crush.mapper_ref import flat_firstn_ref
    from ceph_tpu_torch.crush.mapper_torch import BatchMapper
    from ceph_tpu_torch.ec import registry_instance
    from ceph_tpu_torch.ec.base import to_host
    from ceph_tpu_torch.gf.matrix import recovery_matrix
    from ceph_tpu_torch.ops import _build, telemetry
    from ceph_tpu_torch.ops import crush_kernel as ck
    from ceph_tpu_torch.ops.dispatch import submit_do_rule
    from ceph_tpu_torch.ops.gf_kernel import ec_encode_ref
    from ceph_tpu_torch.tools import crush_test

    rng = np.random.default_rng(8)
    ctx = default_context()
    enc_eng, dec_eng = ctx.dispatch_engine(), ctx.decode_dispatch_engine()
    print(f"engines: max_stripes {enc_eng.max_stripes}, max_delay_us "
          f"{enc_eng.max_delay_us}, depth {enc_eng.max_in_flight}, device "
          f"{enc_eng.device}")
    check(enc_eng.device.type == "cuda" and dec_eng.device.type == "cuda"
          and enc_eng.max_stripes == 2048 and enc_eng.max_in_flight == 2,
          "the context's engines run on the card at the knobs' defaults")
    codec = registry_instance().factory(
        "isa", {"k": str(K), "m": str(M), "technique": "cauchy"})
    coding = codec.generator[K:]
    data = rng.integers(0, 256, (ENGINE_STRIPES, K, CHUNK), dtype=np.uint8)
    sizes = _split(rng, ENGINE_STRIPES, 1, ENGINE_MAX_REQ)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    reqs = [data[offs[i]:offs[i + 1]] for i in range(len(sizes))]
    nbytes = data.nbytes
    result: dict = {}

    def channel(name, eng, reqs_, submit, direct, expect_kernels, oracle,
                unit, amount, io_bytes):
        """One channel: a checked run (launch counts against its calls),
        every delivered row against the direct call, a sample against the
        oracle; a timed run; a profiled run; the direct calls timed."""
        torch.cuda.synchronize()
        b0 = eng.stats.batches
        eng.stats.phases.clear()
        _build.reset_launches()
        got, _ = _drive(reqs_, submit)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        calls = eng.stats.batches - b0
        print(f"{name}: {len(reqs_)} requests in {calls} device calls; "
              f"launches {launches}")
        for kname, per_call in expect_kernels.items():
            want = calls * per_call
            ok = (launches[kname] == want if per_call == 1
                  else launches[kname] >= calls)
            check(ok, f"{name}: {kname} launched {launches[kname]} times "
                  f"for {calls} engine calls (expected "
                  f"{'exactly ' + str(want) if per_call == 1 else '>= ' + str(calls)})")
        want_rows = [direct(r) for r in reqs_]
        check(all(g.shape == w.shape and np.array_equal(g, w)
                  for g, w in zip(got, want_rows)),
              f"{name}: every delivered row == the direct call "
              f"({len(reqs_)} requests)")
        pick = rng.choice(len(reqs_), min(ENGINE_ORACLE, len(reqs_)),
                          replace=False)
        exp = [oracle(reqs_[i]) for i in pick]
        check(all(np.array_equal(got[i][:len(e)], e)
                  for i, e in zip(pick, exp)),
              f"{name}: {len(pick)} sampled requests == the numpy oracle "
              f"({sum(len(e) for e in exp)} rows)")
        assert_no_faults(name)
        # the timed runs come warm, with the checked run's results dropped
        # (a consumer keeps a delivered row only until it has used it, and
        # their pinned blocks go back to the host allocator's cache)
        del got, want_rows
        gc.collect()
        t0 = time.perf_counter()
        for r in reqs_:
            direct(r)
        torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
        gc.collect()
        eng.stats.phases.clear()
        _got2, secs = _drive(reqs_, submit)
        led = _ledger(eng.stats)
        del _got2
        gc.collect()
        prof = _busy(lambda: _drive(reqs_, submit), eng.stats.phases.clear)
        assert_no_faults(f"{name} (timed, profiled)")
        recs = eng.stats.phases.dump()["recent"]
        moved = {"h2d": sum(r["bucket"] for r in recs) * io_bytes[0],
                 "d2h": sum(r["bucket"] for r in recs) * io_bytes[1]}
        rate = amount / secs
        direct_rate = amount / direct_s
        print(f"{name}: engine {rate:,.1f} {unit} ({secs * 1e3:.1f} ms, "
              f"first submit to last delivery)  direct one call a request "
              f"from one thread {direct_rate:,.1f} {unit} "
              f"({direct_s * 1e3:.1f} ms)  {tag}")
        print(f"{name}: calls {led['calls']} (requests {led['requests']}), "
              f"stripes a call mean {led['stripes_per_call_mean']:.1f} "
              f"{led['stripes_per_call_hist']}, buckets {led['buckets']}, "
              f"padding {led['padding_share']:.4f}")
        print(f"{name}: phase medians ms " + "  ".join(
            f"{k} {v:.4f}" for k, v in led["phase_median_ms"].items())
            + f"  (batch e2e {led['e2e_median_ms']:.3f})")
        if prof["complete"]:
            rates = "  ".join(
                f"{d} {moved[d] / 1e6:.1f} MB in {prof[d + '_ms']:.3f} ms "
                f"({moved[d] / prof[d + '_ms'] / 1e6:.1f} GB/s)"
                for d in ("h2d", "d2h") if prof[d + "_ms"])
            print(f"{name}: profiled run: card busy {prof['busy_ms']:.2f} of "
                  f"{prof['window_ms']:.2f} ms ({prof['busy_share']:.4f}); "
                  f"pinned copies {rates or 'none'}; top "
                  f"{[(n[:40], round(t, 3)) for n, t in prof['top']]}  {tag}")
        else:
            print(f"{name}: profiled run: busy share not measured (the trace "
                  f"held {prof['captured']} of {prof['launched']} launches)")
        result[name] = {"engine_rate": rate, "direct_rate": direct_rate,
                        "unit": unit, "engine_ms": secs * 1e3,
                        "direct_ms": direct_s * 1e3, "launches": launches,
                        "engine_calls": calls, "requests": len(reqs_),
                        **led, "busy_share": prof["busy_share"],
                        "busy_ms": prof["busy_ms"],
                        "window_ms": prof["window_ms"],
                        "h2d_ms": prof["h2d_ms"], "d2h_ms": prof["d2h_ms"],
                        "h2d_bytes": moved["h2d"], "d2h_bytes": moved["d2h"]}

    print("-- 8a. EC writes: submit_chunks, isa cauchy k=8 m=4, 4 KiB chunks")
    channel("ec_encode", enc_eng, reqs,
            lambda d: codec.submit_chunks(enc_eng, d),
            lambda d: to_host(codec.encode_chunks(d)),
            {"gf_matvec": 1},
            lambda d: ec_encode_ref(coding, d), "MB/s", nbytes / 1e6,
            (K * CHUNK, M * CHUNK))
    check(enc_eng._staging.allocated < enc_eng.stats.batches,
          f"pinned staging reused its buffers: {enc_eng._staging.allocated} "
          f"buffers for {enc_eng.stats.batches} batches at depth "
          f"{enc_eng.max_in_flight}, every row held")

    print("-- 8b. degraded reads: submit_decode_chunks, patterns "
          f"{ENGINE_PATTERNS}")
    pats = []
    for erased in ENGINE_PATTERNS:
        chosen = tuple(i for i in range(K + M) if i not in erased)[:K]
        pats.append((chosen, tuple(erased)))
    dreqs = [(r, pats[i % len(pats)]) for i, r in enumerate(reqs)]
    channel("ec_decode", dec_eng, dreqs,
            lambda q: codec.submit_decode_chunks(dec_eng, q[1][0], q[0],
                                                 q[1][1]),
            lambda q: to_host(codec.decode_chunks(q[1][0], q[0], q[1][1])),
            {"gf_matvec": 1},
            lambda q: ec_encode_ref(recovery_matrix(
                codec.generator, list(q[1][0]), list(q[1][1])), q[0]),
            "MB/s", nbytes / 1e6, (K * CHUNK + 4, M * CHUNK))
    dstats = dec_eng.stats.summary()
    print(f"decode: mean patterns a call {dstats['mean_patterns']}, pattern "
          f"table {dstats['pattern_table_size']}")
    check(dstats["mean_patterns"] > 1.0,
          "decode calls mixed erasure patterns in one launch")

    print("-- 8c. remaps: crush_test --osds 1024 (submit_flat_firstn), "
          "65,536 PGs")
    fmap, _froot, frid = build_flat_map(FLAT_OSDS)
    fids = np.asarray(fmap.bucket(-1).items, dtype=np.int32)
    fw = np.asarray(fmap.bucket(-1).item_weights, dtype=np.int64)
    frw = np.full(FLAT_OSDS, 0x10000, dtype=np.int64)
    torch.cuda.synchronize()
    runs_ = []
    for cold in (True, False):
        quiet = io.StringIO()
        _build.reset_launches()
        b0 = enc_eng.stats.batches
        enc_eng.stats.phases.clear()
        t0 = time.perf_counter()
        st = crush_test.run_test(fmap, [frid], 0, N_PGS - 1, NUMREP,
                                 out=quiet)[frid]
        secs_ = time.perf_counter() - t0
        runs_.append((st, secs_, dict(_build.LAUNCHES),
                      enc_eng.stats.batches - b0, _ledger(enc_eng.stats)))
        when = ("cold: the flat root's tables built in the first call"
                if cold else "warm")
        print(f"crush_test --osds {FLAT_OSDS} ({when}): "
              f"{N_PGS / secs_:,.0f} mappings/s ({secs_ * 1e3:.1f} ms, "
              f"the rows and counts on the host included), "
              f"{runs_[-1][3]} engine calls, launches {runs_[-1][2]}  {tag}")
    print(quiet.getvalue().rstrip())
    st_cold = runs_[0][0]
    st, flat_s, flat_launch, flat_calls, led = runs_[1]
    check(st_cold["rows"] == st["rows"],
          "crush_test --osds: the cold and the warm run agree")
    print(f"crush_test --osds {FLAT_OSDS}: calls {led['calls']}, phase "
          f"medians ms " + "  ".join(f"{k} {v:.4f}" for k, v in
                                     led["phase_median_ms"].items()))
    check(flat_launch["firstn_consume"] >= flat_calls > 0
          and flat_launch["straw2_froot"] + flat_launch["straw2_root"]
          >= flat_calls,
          f"crush_test --osds: {flat_calls} engine calls launched the root "
          f"(filter) and consume kernels")
    x_all = torch.arange(N_PGS, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    direct = np.concatenate([ck.flat_firstn(x_all[i:i + 2048], fids, fw, frw,
                                            numrep=NUMREP).cpu().numpy()
                             for i in range(0, N_PGS, 2048)])
    flat_direct_s = time.perf_counter() - t0
    rows = [[v for v in r if v != NONE_ID] for r in direct.tolist()]
    check(rows == st["rows"], f"crush_test --osds {FLAT_OSDS}: every row == "
          f"the direct flat_firstn call, {N_PGS} PGs")
    check(np.array_equal(direct[:ORACLE_PGS], np.asarray(flat_firstn_ref(
        np.arange(ORACLE_PGS), fids, fw, frw, numrep=NUMREP))),
          f"flat firstn: {ORACLE_PGS} PGs == flat_firstn_ref")
    assert_no_faults("crush_test --osds")
    print(f"flat firstn direct, one call a 2048-PG chunk from one thread: "
          f"{N_PGS / flat_direct_s:,.0f} mappings/s  {tag}")
    result["crush_firstn"] = {
        "engine_rate": N_PGS / flat_s, "cold_rate": N_PGS / runs_[0][1],
        "direct_rate": N_PGS / flat_direct_s, "unit": "mappings/s",
        "engine_calls": flat_calls, "launches": flat_launch, **led}

    print("-- 8d. remaps: submit_do_rule on the flagship 10k-OSD map, "
          "chooseleaf firstn 3, 65,536 PGs")
    bmap, brid, brw = bench_map()
    mapper = BatchMapper(bmap)
    psizes = _split(rng, N_PGS, *ENGINE_RULE_REQ)
    poffs = np.concatenate([[0], np.cumsum(psizes)])
    preqs = [xs_np[poffs[i]:poffs[i + 1]] for i in range(len(psizes))]
    brw_list = [int(v) for v in brw]
    channel("crush_rule", enc_eng, preqs,
            lambda x: submit_do_rule(enc_eng, mapper, brid, x, NUMREP, brw),
            lambda x: mapper.do_rule(brid, x, NUMREP, brw).cpu().numpy(),
            {"straw2_root": 0, "straw2_leaf": 0, "firstn_consume": 0},
            lambda x: rows_of(bmap, brid, x[:ENGINE_RULE_ORACLE], brw_list),
            "mappings/s", N_PGS, (8, NUMREP * 4))

    print("-- 8e. the ladder, armed on purpose: dispatch.block_until_ready"
          ":ec_encode")
    assert_no_faults("before the armed sub-phase")
    fst = enc_eng.stats
    one = reqs[0]
    want = to_host(codec.encode_chunks(one))

    def faults():
        return fst.fault_dump()

    failpoint.set("dispatch.block_until_ready:ec_encode", "oneshot")
    got = codec.submit_chunks(enc_eng, one).result(timeout=60)
    f1 = faults()
    check(np.array_equal(got, want) and f1["retries"] == 1
          and f1["retry_successes"] == 1 and f1["fallback_batches"] == 0
          and f1["breaker_opens"] == 0,
          f"one failed synchronize: the batch retried once and came out "
          f"bit-exact ({f1['retries']} retry, {f1['retry_successes']} "
          f"healed, 0 fallback)")
    failpoint.set("dispatch.block_until_ready:ec_encode", "always")
    retries = enc_eng.fault_max_retries
    threshold = enc_eng.breaker_threshold
    for i in range(threshold + 2):
        got = codec.submit_chunks(enc_eng, reqs[i]).result(timeout=60)
        check(np.array_equal(got, to_host(codec.encode_chunks(reqs[i])))
              if i else np.array_equal(got, want),
              f"persistent fault, batch {i + 1}: bit-exact from the host "
              f"oracle")
    f2 = faults()
    check(f2["retries"] == 1 + threshold * retries
          and f2["retry_successes"] == 1
          and f2["fallback_batches"] == threshold + 2
          and f2["breaker_opens"] == 1
          and enc_eng.breaker_states()["ec_encode"]
          != telemetry.BREAKER_CLOSED,
          f"persistent fault: {threshold} batches each retried {retries} "
          f"times, then the breaker opened; {threshold + 2} batches served "
          f"by the host oracle (retries {f2['retries']}, fallback "
          f"{f2['fallback_batches']}, opens {f2['breaker_opens']})")
    failpoint.clear()
    deadline = time.monotonic() + 30
    while (enc_eng.breaker_states()["ec_encode"] != telemetry.BREAKER_CLOSED
           and time.monotonic() < deadline):
        time.sleep(0.02)
    f3 = faults()
    check(enc_eng.breaker_states()["ec_encode"] == telemetry.BREAKER_CLOSED
          and f3["breaker_closes"] == 1 and f3["probe_successes"] == 1,
          f"disarmed: the probe re-closed the breaker ({f3['probe_failures']}"
          f" failed probes while armed, {f3['probe_successes']} success)")
    _build.reset_launches()
    got = codec.submit_chunks(enc_eng, one).result(timeout=60)
    f4 = faults()
    check(np.array_equal(got, want) and _build.LAUNCHES["gf_matvec"] == 1
          and f4["fallback_batches"] == f3["fallback_batches"],
          "after re-close the encode runs on the card again, bit-exact")
    result["ladder"] = {k: f4[k] for k in (
        "retries", "retry_successes", "fallback_batches", "breaker_opens",
        "breaker_closes", "probe_successes", "probe_failures")}
    return result


def _oracle_chunk(args):
    """The scalar oracle pg_to_up_acting_osds over (pool, pg) pairs of one
    map: a worker process's share."""
    m, keys = args
    return [m.pg_to_up_acting_osds(pid, pg) for pid, pg in keys]


def scalar_oracle(pool_exec, m, keys: list) -> dict:
    """pg_to_up_acting_osds of every key, computed in ``pool_exec``'s worker
    processes (the pure-Python rule engine on a 10,000-OSD map takes 25-100
    ms a PG)."""
    step = max(1, -(-len(keys) // 64))
    chunks = [keys[i:i + step] for i in range(0, len(keys), step)]
    out: dict = {}
    for chunk, rows in zip(chunks, pool_exec.map(
            _oracle_chunk, [(m, c) for c in chunks])):
        out.update(zip(chunk, rows))
    return out


def ladder_operands_case(rng, n: int, w: int, p: int, erasure: bool,
                         m_osd: int | None = None):
    """Seeded adversarial operands of the fused tail (the LadderOperands
    fields, numpy): few OSDs (or ``m_osd``), ids past max_osd, NONE holes,
    NONE frm pairs, targets in the row, out or down, upmap rows valid or
    not, empty and short temps, primary_temp, affinity all default or not,
    and an all-zero row in the middle (a padded bucket's row)."""
    import numpy as np
    none, nosd = NONE_ID, -1
    if m_osd is None:
        m_osd = int(rng.integers(1, 24))
    hi = m_osd + 3
    state = rng.choice([0, 1, 2, 3, 3, 3, 3], m_osd).astype(np.int32)
    weight = rng.choice([0, 0x10000, 0x10000, 0x8000, 1 << 40],
                        m_osd).astype(np.int64)
    affinity = (np.full(m_osd, 0x10000, dtype=np.int32) if rng.random() < .3
                else rng.choice([0, 0x10000, 0x10000, 0x8000, 0x1234],
                                m_osd).astype(np.int32))
    raw = rng.integers(0, hi, (n, w)).astype(np.int32)
    raw[rng.random((n, w)) < 0.2] = none
    raw_len = np.full(n, w, dtype=np.int32)
    if erasure:
        short = rng.random(n) < 0.2
        raw_len[short] = rng.integers(0, w + 1, int(short.sum()))
    up_rows = np.full((n, w), none, dtype=np.int32)
    up_len = np.zeros(n, dtype=np.int32)
    for i in np.flatnonzero(rng.random(n) < 0.15):
        k = int(rng.integers(1, w + 1))
        up_rows[i, :k] = rng.integers(0, hi, k)
        up_len[i] = k
    items = np.full((n, p, 2), -1, dtype=np.int32)
    for i in np.flatnonzero(rng.random(n) < 0.5):
        for j in range(int(rng.integers(1, p + 1))):
            frm = (none if rng.random() < 0.15
                   else int(raw[i, rng.integers(0, w)]))
            to = (int(raw[i, rng.integers(0, w)]) if rng.random() < 0.2
                  else int(rng.integers(0, hi)))
            items[i, j] = (frm, to)
    temp_rows = np.full((n, w), nosd, dtype=np.int32)
    temp_len = np.zeros(n, dtype=np.int32)
    for i in np.flatnonzero(rng.random(n) < 0.15):
        k = int(rng.integers(0, w + 1))
        temp_rows[i, :k] = rng.integers(-1, hi, k)
        temp_len[i] = k
    ptemp = np.where(rng.random(n) < 0.1, rng.integers(0, hi, n),
                     nosd).astype(np.int32)
    pps = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    case = dict(raw=raw, pps=pps, raw_len=raw_len, up_rows=up_rows,
                up_len=up_len, items=items, temp_rows=temp_rows,
                temp_len=temp_len, ptemp=ptemp, state=state, weight=weight,
                affinity=affinity, erasure=erasure, width=w)
    if n > 2:
        for f in ("raw", "pps", "raw_len", "up_rows", "up_len", "items",
                  "temp_rows", "temp_len", "ptemp"):
            case[f][n // 2] = 0
    return case


def on_card(op, dev):
    """A LadderOperands' arrays as card tensors: the per-PG ones in
    finish_ladder's order, then the three per-OSD vectors."""
    import numpy as np
    import torch
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (op.raw,) + op.aux() + (op.state, op.weight,
                                              op.affinity)]


def launch_ladder(t, words, erasure: bool, out) -> None:
    """One raw pg_finish_ladder launch on prepared card operands ``t``
    (finish_ladder's order, int32 but weight int64; 16-byte aligned, as
    fresh tensors are) and the word table ``words`` into ``out``."""
    from ceph_tpu_torch.ops import _build
    n, w = t[0].shape
    _build.launch("pg_finish_ladder", "pg_finish_ladder_launch",
                  *[a.data_ptr() for a in t[:9]], words.data_ptr(),
                  t[9].shape[0], n, w, t[5].shape[1], int(erasure),
                  out.data_ptr())


def ladder_bound(op, packed) -> tuple[float, str]:
    """The fused tail's bound on these operands, counting only the bytes
    this data makes the function read: every row's raw cells, pairs,
    up_len, temp_len and ptemp; raw_len on an erasure pool only; a row's
    pg_upmap cells (up_len of them), its pg_temp row and its pps only where
    it has one or its up members do not all have default affinity; the
    per-OSD word table (4 bytes an OSD) once; the packed table written
    once.  The
    operations: the coin-flip hashes this data needs (one hash32_2 per up
    member of those rows)."""
    import numpy as np
    n, w = op.raw.shape
    up = packed[:, :w]
    real = up != -1
    aff = np.where(real, op.affinity[np.clip(up, 0, len(op.affinity) - 1)],
                   0x10000)
    rows = (real & (aff != 0x10000)).any(axis=1)
    nbytes = (op.raw.nbytes + op.items.nbytes + op.up_len.nbytes
              + op.temp_len.nbytes + op.ptemp.nbytes
              + (op.raw_len.nbytes if op.erasure else 0)
              + 4 * int(op.up_len.sum())
              + 4 * w * int((op.temp_len > 0).sum())
              + 4 * int(rows.sum())
              + 4 * len(op.state) + packed.nbytes)
    hashes = int(real[rows].sum())
    return bound(nbytes, hashes * HASH2_OPS)


def ladder_padding(op, packed, size: int) -> tuple[int, int]:
    """(bytes, of which padding): what one pool's tail moves through the
    engine (its dense operand tables to the card, its packed table back),
    and the part of it that is cells past the pool's own size in the
    tables' width W (raw, pg_upmap and pg_temp rows; up and acting)."""
    import numpy as np
    w = op.raw.shape[1]
    moved = (sum(np.asarray(a).nbytes for a in (op.raw,) + op.aux())
             + packed.nbytes)
    pad = (sum(a[:, size:].nbytes for a in (op.raw, op.up_rows,
                                             op.temp_rows))
           + packed[:, size:w].nbytes + packed[:, w + size:2 * w].nbytes)
    return moved, pad


def ladder_cases(dev, tag: str) -> int:
    """Phase 9g: pg_finish_ladder (and pg_osd_words) against ladder_plain
    and ladder_ref (osd_words_plain) on adversarial operands: every W of
    1..32 at P 1, 2, 4 and N 1, 37, 203 (a pad row in the middle),
    replicated and erasure; then maps of 10,000 and 60,000 OSDs (a word
    table of 40 KB, which L1 can hold, and of 240 KB, which it cannot) on
    LADDER_BIG_N rows (many tiles, the last one ragged).  Returns the
    number of cases."""
    import numpy as np
    import torch

    from ceph_tpu_torch.ops import placement_cuda as pc
    from ceph_tpu_torch.ops import placement_kernel as pk
    arng = np.random.default_rng(99)
    shapes = [(w, p, erasure, n, None) for w in LADDER_WIDTHS
              for p in LADDER_PAIRS for erasure in (False, True)
              for n in LADDER_NS]
    shapes += [(w, 4, erasure, LADDER_BIG_N, m)
               for m in (N_OSDS, 60000)
               for w in (3, 12) for erasure in (False, True)]
    for w, p, erasure, n, m_osd in shapes:
        case = ladder_operands_case(arng, n, w, p, erasure, m_osd)
        op = pk.LadderOperands(**case)
        t = on_card(op, dev)
        words = pc.osd_words(*t[9:12])
        if not torch.equal(words, pc.osd_words_plain(*t[9:12])):
            raise SmokeFailure(f"pg_osd_words != plain at M={len(op.state)}")
        got = pc.finish_ladder(*t, erasure=erasure, words=words)
        got = got.cpu().numpy()
        want = pk.ladder_plain(*t, erasure=erasure).cpu().numpy()
        ref = pk.ladder_ref(op.raw, *op.aux(), op.state, op.weight,
                            op.affinity, erasure=erasure)
        if not (np.array_equal(got, want) and np.array_equal(got, ref)):
            raise SmokeFailure(
                f"pg_finish_ladder != plain at W={w} P={p} N={n} "
                f"M={len(op.state)} erasure={erasure}")
    check(True, f"pg_finish_ladder == ladder_plain == ladder_ref and "
          f"pg_osd_words == osd_words_plain on {len(shapes)} adversarial "
          f"cases (W 1..32, P {LADDER_PAIRS}, N {LADDER_NS}, replicated and "
          f"erasure, a pad row in the middle; {N_OSDS} and 60,000 OSDs on "
          f"{LADDER_BIG_N} rows, the last tile ragged)  {tag}")
    return len(shapes)


def remap_split(recent: list) -> dict:
    """Each pool's remap batch of one epoch, from the engine's phase
    ledger (the newest crush_rule batch of each row count): the host's
    launch phase (issuing the calls: the indep interpreter's torch ops, the
    fast path's kernels) and compute (launch end to the batch's CUDA
    event), ms."""
    out = {}
    for r in reversed(recent):
        if r["kernel"] == "crush_rule" and r["stripes"] not in out:
            out[r["stripes"]] = {ph: r["phases"][ph] * 1e3
                                 for ph in ("launch", "compute")}
    return out


def mapping_phase(dev, tag: str) -> tuple[dict, list, dict]:
    """Phase 9: the OSDMap and the shared PG mapping service on the card
    (see the module docstring); returns (summary, the kernel rows of
    pg_finish_ladder and pg_osd_words, {"ctx", "map"}: the phase's context,
    not stopped, and its e4 map, for phase 13b)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from ceph_tpu_torch.common.context import CephTpuContext
    from ceph_tpu_torch.crush.builder import add_simple_rule
    from ceph_tpu_torch.ops import _build, telemetry
    from ceph_tpu_torch.ops import placement_cuda as pc
    from ceph_tpu_torch.ops import placement_kernel as pk
    from ceph_tpu_torch.osd import OSDMap, PGPool
    from ceph_tpu_torch.osd.osdmap import OSD_EXISTS, OSD_UP
    from ceph_tpu_torch.tools import osdmap_test, psim

    rng = np.random.default_rng(9)
    # the counters of earlier phases (8e armed the ladder on purpose) start
    # this phase at zero
    telemetry.reset()
    crush, rid, reweight = bench_map()
    ec_rid = add_simple_rule(crush, -1, 1, mode="indep")
    m1 = OSDMap(crush=crush, epoch=1)
    m1.set_max_osd(N_OSDS)
    for o in range(N_OSDS):
        m1.mark_up(o, int(reweight[o]))
    m1.pools[1] = PGPool(pool_id=1, size=NUMREP, crush_rule=rid,
                         pg_num=MAP_REP_PGS)
    m1.pools[2] = PGPool(pool_id=2, type=3, size=MAP_EC_SIZE,
                         crush_rule=ec_rid, pg_num=MAP_EC_PGS,
                         ec_profile={"k": "8", "m": "4"})
    replicas = sum(p.size * p.pg_num for p in m1.pools.values())
    print(f"cluster: {N_OSDS} OSDs (250 hosts x 40), pool 1 replicated size "
          f"{NUMREP} pg_num {MAP_REP_PGS}, pool 2 erasure k=8 m=4 pg_num "
          f"{MAP_EC_PGS}: {replicas} PG replicas, "
          f"{replicas / N_OSDS:.1f} per OSD")
    samples = {pid: sorted(int(pg) for pg in rng.choice(
        m1.pools[pid].pg_num, n, replace=False))
        for pid, n in MAP_SAMPLE.items()}

    ctx = CephTpuContext("mapping")
    svc = ctx.mapping_service()
    st = telemetry.mapping_stats()
    out_osds = np.flatnonzero(reweight == 0)
    summary: dict = {"epochs": {}}
    ladder_launches: list[int] = []
    words_launches: list[int] = []
    pool_launches: dict = {}
    max_err = 0

    def phases() -> dict:
        d = st.dump()["phase_seconds"]
        return {k: v["sum"] for k, v in d.items()}

    def checked_keys(m) -> list:
        keys = {(pid, pg) for pid, pgs in samples.items() for pg in pgs}
        for attr in ("pg_upmap", "pg_upmap_items", "pg_temp",
                     "primary_temp"):
            keys.update(getattr(m, attr))
        return sorted(keys)

    def ladder_of(m, pid):
        """The service's packed table of one pool, and the operands it was
        built from (the service's raw and pps tables, at the pool's own
        width)."""
        mp = svc._mapping
        width, pairs = pk.pool_widths(m, {pid: m.pools[pid]})
        op = pk.build_operands(m, pid, m.pools[pid], mp._raw[pid],
                               mp._pps[pid], width=width, pairs=pairs)
        return mp._fused[pid], op

    def epoch(name, m, prev, straw2: bool, pool_exec):
        nonlocal max_err
        ph0 = phases()
        up0 = st.dump()["diff_uploads"]
        _build.reset_launches()
        pc.reset_shape_launches()
        t0 = time.perf_counter()
        upd = svc.update_to(m)
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        shapes = dict(pc.SHAPE_LAUNCHES)
        uploads = st.dump()["diff_uploads"] - up0
        ph = {k: v - ph0[k] for k, v in phases().items()}
        ladder_launches.append(launches["pg_finish_ladder"])
        words_launches.append(launches["pg_osd_words"])
        for shape, k in shapes.items():
            pool_launches[shape] = pool_launches.get(shape, 0) + k
        split = (remap_split(telemetry.dispatch_stats().phases.dump()
                             ["recent"]) if straw2 else None)
        print(f"{name}: update_to {secs:.3f} s (device {ph['device']:.3f}, "
              f"delta {ph['delta'] * 1e3:.2f} ms, host_tail "
              f"{ph['host_tail']:.3f}); "
              f"{'full' if upd.full else len(upd.changed)} changed PGs; "
              f"launches {launches}; pg_finish_ladder by (W, P, erasure) "
              f"{shapes}; packed tables uploaded for the diff {uploads}  "
              f"{tag}")
        if split:
            print(f"{name}: the remaps on the engine, ms by pool (launch: "
                  f"the host issuing the calls; compute: launch end to the "
                  f"batch's event): pool 1 (fast path, {MAP_REP_PGS} PGs) "
                  f"{split.get(MAP_REP_PGS)}, pool 2 (chooseleaf indep "
                  f"interpreter, {MAP_EC_PGS} PGs) {split.get(MAP_EC_PGS)}  "
                  f"{tag}")
        check(launches["pg_finish_ladder"] >= 1,
              f"{name}: pg_finish_ladder launched "
              f"{launches['pg_finish_ladder']} times, one a pool at its own "
              f"(W, P) {shapes}")
        check(launches["pg_osd_words"] == 1,
              f"{name}: pg_osd_words packed the epoch's word table once")
        check(uploads == 0 and all(
            pid in svc._mapping._fused_dev for pid in m.pools),
              f"{name}: every pool's packed table kept on the card, no "
              f"table uploaded for the diff")
        s2 = {k: launches[k] for k in ("straw2_root", "straw2_leaf",
                                       "firstn_consume")}
        check(all(v >= 1 for v in s2.values()) if straw2
              else not any(s2.values()),
              f"{name}: the straw2 kernels "
              + ("remap the pools" if straw2 else "do not launch (the raw "
                 "tables are reused)") + f" ({s2})")
        check(upd.full == (prev is None),
              f"{name}: " + ("a full first build" if prev is None
                             else "an incremental delta, no full rescan"))
        for pid in m.pools:
            packed, op = ladder_of(m, pid)
            want = pk.ladder_ref(op.raw, *op.aux(), op.state, op.weight,
                                 op.affinity, erasure=op.erasure)
            check(np.array_equal(packed, want),
                  f"{name}: pool {pid}'s packed table == numpy ladder_ref "
                  f"on all {packed.shape[0]} rows")
            t = on_card(op, dev)
            got = pc.finish_ladder(*t, erasure=op.erasure)
            plain_ = pk.ladder_plain(*t, erasure=op.erasure)
            err = int((got.long() - plain_.long()).abs().max())
            max_err = max(max_err, err)
            check(err == 0 and np.array_equal(got.cpu().numpy(), packed)
                  and torch.equal(svc._mapping._fused_dev[pid], got),
                  f"{name}: pool {pid} (W={op.width}): the kernel == "
                  f"ladder_plain on the card and == the service's table, "
                  f"on the host and on the card")
        keys = checked_keys(m)
        t_o = time.perf_counter()
        oracle = scalar_oracle(pool_exec, m, keys)
        got = {k: svc.lookup(m, *k) for k in keys}
        bad = [k for k in keys if got[k] != oracle[k]]
        check(not bad, f"{name}: lookup == pg_to_up_acting_osds on "
              f"{len(keys)} PGs (every override-named PG and the seeded "
              f"sample; oracle {time.perf_counter() - t_o:.1f} s) "
              f"{bad[:3]}")
        if prev is not None:
            want_delta = []
            for pid, pool in m.pools.items():
                a, wa = prev[pid]
                b, wb = svc._mapping._fused[pid], svc._mapping._fused_w[pid]
                w = max(wa, wb)
                diff = (pk.normalize_packed(a, wa, w)
                        != pk.normalize_packed(b, wb, w)).any(axis=1)
                want_delta += [(pid, int(pg)) for pg in np.flatnonzero(diff)]
            check(sorted(upd.changed) == sorted(want_delta),
                  f"{name}: the delta == the rows where the packed tables "
                  f"differ ({len(want_delta)} PGs, a host compare)")
        d = st.dump()
        check(d["unfused_epochs"] == 0 and d["lookup_fallbacks"] == 0,
              f"{name}: MappingStats unfused_epochs 0, lookup_fallbacks 0 "
              f"(fused epochs {d['fused_epochs']}, lookups {d['lookups']})")
        assert_no_faults(name)
        summary["epochs"][name] = {
            "update_to_s": secs, "phases_s": ph,
            "changed": None if upd.full else len(upd.changed),
            "launches": launches, "checked_pgs": len(keys),
            "ladder_shapes": {str(k): v for k, v in shapes.items()},
            "diff_uploads": uploads, "remap_split_ms": split}
        return {pid: (svc._mapping._fused[pid].copy(),
                      svc._mapping._fused_w[pid]) for pid in m.pools}

    ctx_mp = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx_mp) as pool_exec:
        print("-- 9a. e1: the base map, every pool built")
        prev = epoch("e1", m1, None, True, pool_exec)
        raw1 = {pid: svc._mapping._raw[pid] for pid in m1.pools}

        print("-- 9b. e2: overrides only (upmap items and rows, temps, "
              "primary affinity)")
        m2 = m1.copy()
        m2.epoch = 2
        osds = np.arange(N_OSDS)
        for pid, count in ((1, MAP_ITEMS), (2, MAP_EC_ITEMS)):
            for pg in rng.choice(m2.pools[pid].pg_num, count, replace=False):
                row = [int(v) for v in raw1[pid][pg]]
                pairs = []
                for _ in range(int(rng.integers(1, 4))):
                    kind = rng.random()
                    frm = (NONE_ID if pid == 2 and kind < 0.2
                           else row[int(rng.integers(0, len(row)))])
                    if kind < 0.15:       # invalid: the target is out
                        to = int(rng.choice(out_osds))
                    elif kind < 0.3:      # invalid: already in the row
                        to = row[int(rng.integers(0, len(row)))]
                    else:
                        to = int(rng.integers(0, N_OSDS))
                    pairs.append((frm, to))
                m2.pg_upmap_items[(pid, int(pg))] = pairs
        for pg in rng.choice(MAP_REP_PGS, MAP_UPMAP, replace=False):
            lst = [int(v) for v in rng.choice(osds, NUMREP, replace=False)]
            if rng.random() < 0.25:       # invalid: names an out OSD
                lst[int(rng.integers(0, NUMREP))] = int(rng.choice(out_osds))
            m2.pg_upmap[(1, int(pg))] = lst
        for pid, count, size in ((1, MAP_TEMP, NUMREP),
                                 (2, MAP_EC_TEMP, MAP_EC_SIZE)):
            for pg in rng.choice(m2.pools[pid].pg_num, count, replace=False):
                ln = 0 if rng.random() < 0.1 else size
                m2.pg_temp[(pid, int(pg))] = [
                    int(v) for v in rng.choice(osds, ln, replace=False)]
        for pid, count in ((1, MAP_PTEMP), (2, MAP_EC_PTEMP)):
            for pg in rng.choice(m2.pools[pid].pg_num, count, replace=False):
                m2.primary_temp[(pid, int(pg))] = int(rng.integers(0,
                                                                   N_OSDS))
        perm = rng.permutation(N_OSDS)
        for o in perm[:N_OSDS // 20]:
            m2.osd_primary_affinity[int(o)] = 0x8000
        for o in perm[N_OSDS // 20:N_OSDS // 20 + N_OSDS // 100]:
            m2.osd_primary_affinity[int(o)] = 0
        widths = {pid: pk.pool_widths(m2, {pid: pool})
                  for pid, pool in m2.pools.items()}
        print(f"e2 overrides: {len(m2.pg_upmap_items)} pg_upmap_items, "
              f"{len(m2.pg_upmap)} pg_upmap, {len(m2.pg_temp)} pg_temp, "
              f"{len(m2.primary_temp)} primary_temp; (W, P) by pool "
              f"{widths} (one width for all: {pk.pool_widths(m2)})")
        prev = epoch("e2", m2, prev, False, pool_exec)
        check(all(svc._mapping._raw[p] is raw1[p] for p in m2.pools),
              "e2: every raw table reused")
        # what_if_up: the balancer's batched scoring, one more ladder
        cands = [(int(pg), [(int(raw1[1][pg][0]),
                             int(rng.integers(0, N_OSDS)))])
                 for pg in samples[1][:256]]
        _build.reset_launches()
        wi = svc.what_if_up(m2, 1, cands)
        wi_launch = _build.LAUNCHES["pg_finish_ladder"]
        want_wi = []
        for pg, prs in cands:
            row = [o for o in map(int, raw1[1][pg]) if o != NONE_ID]
            for frm, to in prs:
                if (frm in row and to not in row and m2.exists(to)
                        and not m2.is_out(to)):
                    row[row.index(frm)] = to
            want_wi.append(m2._raw_to_up_osds(m2.pools[1], row)[0])
        check(wi == want_wi and wi_launch == 1,
              f"what_if_up on {len(cands)} candidates == the host pipeline "
              f"(raw + pairs + state filter), one pg_finish_ladder launch")

        print("-- 9c. e3: 100 OSDs down, one whole host among them")
        m3 = m2.copy()
        m3.epoch = 3
        host = crush.bucket(crush.bucket(-1).items[7])
        down = [int(o) for o in host.items]
        down += [int(o) for o in rng.permutation(N_OSDS)
                 if int(o) not in set(host.items)][:100 - len(down)]
        for o in down:
            m3.osd_state[o] = OSD_EXISTS
        check(set(host.items) <= set(down) and len(down) == 100,
              f"e3: {len(down)} OSDs down, host {host.id}'s "
              f"{len(host.items)} among them")
        prev = epoch("e3", m3, prev, False, pool_exec)
        check(all(svc._mapping._raw[p] is raw1[p] for p in m3.pools),
              "e3: every raw table reused, the tail re-run")

        print("-- 9d. e4: 1% of OSDs reweighted to 0x8000, 20 marked out")
        m4 = m3.copy()
        m4.epoch = 4
        perm = rng.permutation(N_OSDS)
        for o in perm[:N_OSDS // 100]:
            m4.osd_weight[int(o)] = 0x8000
        for o in perm[N_OSDS // 100:N_OSDS // 100 + 20]:
            m4.osd_weight[int(o)] = 0
        prev = epoch("e4", m4, prev, True, pool_exec)
        check(all(svc._mapping._raw[p] is not raw1[p] for p in m4.pools),
              "e4: both pools remapped through submit_do_rule")

        print("-- 9e. e5 = e4's content with osdmap_mapping_fused off")
        ctx.conf.set("osdmap_mapping_fused", False)
        m5 = m4.copy()
        m5.epoch = 5
        t0 = time.perf_counter()
        upd5 = svc.update_to(m5)
        secs5 = time.perf_counter() - t0
        keys = checked_keys(m4)
        off = [svc.lookup(m5, *k) for k in keys]
        on = [pk.unpack_row(prev[pid][0][pg], prev[pid][1])
              for pid, pg in keys]
        check(off == on and not upd5.full and list(upd5.changed) == []
              and not svc._mapping.fused_complete(),
              f"e5, fused off: {len(keys)} host-tail lookups == e4's fused "
              f"rows, empty delta ({secs5:.3f} s)")
        ctx.conf.set("osdmap_mapping_fused", True)
    summary["fused_off_s"] = secs5
    fin = [r for r in telemetry.dispatch_stats().phases.dump()["recent"]
           if r["kernel"] == "pg_finish"]
    led = {"calls": len(fin), "rows": [r["stripes"] for r in fin],
           "phase_median_ms": {
               ph: statistics.median(r["phases"][ph] for r in fin) * 1e3
               for ph in telemetry.PHASES} if fin else {},
           "by_rows": {n: {ph: statistics.median(
               r["phases"][ph] for r in fin if r["stripes"] == n) * 1e3
               for ph in telemetry.PHASES}
               for n in (MAP_REP_PGS, MAP_EC_PGS)
               if any(r["stripes"] == n for r in fin)}}
    print(f"pg_finish channel: {led['calls']} engine calls of {led['rows']} "
          f"rows; phase medians ms " + "  ".join(
              f"{k} {v:.4f}" for k, v in led["phase_median_ms"].items())
          + f"  {tag}")
    for n, meds in led["by_rows"].items():
        print(f"pg_finish channel, the calls of {n} rows: phase medians ms "
              + "  ".join(f"{k} {v:.4f}" for k, v in meds.items())
              + f"  {tag}")
    summary["pg_finish_ledger"] = led
    assert_no_faults("phase 9")

    print("-- 9f. osdmaptool --test-map-pgs on this cluster; psim")
    buf = io.StringIO()
    res = osdmap_test.test_map_pgs(m4, out=buf)
    print(buf.getvalue().rstrip() + f"  {tag}")
    check(res["pg_total"] == MAP_REP_PGS + MAP_EC_PGS,
          f"osdmap_test: {res['pg_total']} PGs mapped at "
          f"{res['pgs_per_s']:,.0f} pg mappings/s")
    sim = psim.simulate(250, 40, MAP_REP_PGS, NUMREP)
    print(f"psim 250 x 40, {MAP_REP_PGS} objects: {json.dumps(sim)}  {tag}")
    check(sim["placements"] == MAP_REP_PGS * NUMREP,
          "psim placed every object's replicas")
    summary["osdmap_test"] = {k: res[k] for k in (
        "pg_total", "osd_count", "avg", "min", "max", "elapsed_s",
        "pgs_per_s")}
    summary["psim"] = sim

    print("-- 9g. pg_finish_ladder against ladder_plain and ladder_ref on "
          "adversarial operands")
    ladder_cases(dev, tag)

    print("-- 9h. times: each pool's kernel at its own e4 shape; the one "
          "width of the first layout beside it")
    mp = svc._mapping
    pools: dict = {}
    moved = pad = 0
    for pid, pool in m4.pools.items():
        width, pairs = pk.pool_widths(m4, {pid: pool})
        t_b = time.perf_counter()
        op = pk.build_operands(m4, pid, pool, mp._raw[pid], mp._pps[pid],
                               width=width, pairs=pairs)
        build_s = time.perf_counter() - t_b
        t = on_card(op, dev)
        words = pc.osd_words(*t[9:12])
        out = torch.empty((op.raw.shape[0], 2 * op.width + 4),
                          dtype=torch.int32, device=dev)
        g, h = paired_times(lambda: launch_ladder(t, words, op.erasure, out),
                            20)
        ms, host = statistics.median(g), statistics.median(h)
        packed4 = prev[pid][0]
        check(torch.equal(out.cpu(), torch.from_numpy(packed4)),
              f"pool {pid}: the raw launch wrote e4's table")
        plain_ms = time_ms(lambda: pk.ladder_plain(*t, erasure=op.erasure),
                           1, reps=5)
        b_ms, b_by = ladder_bound(op, packed4)
        mv, pd = ladder_padding(op, packed4, int(pool.size))
        moved, pad = moved + mv, pad + pd
        n_, w_ = op.raw.shape
        shape = f"N={n_} W={w_} P={op.items.shape[1]}"
        launches = sum(k for (_w, _p, erasure), k in pool_launches.items()
                       if erasure == op.erasure)
        print(f"pg_finish_ladder pool {pid} {shape} kernel {ms:.4f} ms "
              f"(graph replay; {host:.4f} issued)  plain {plain_ms:.4f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})  launches over e1-e4 "
              f"{launches}  build_operands on the host "
              f"{build_s * 1e3:.1f} ms  tail {mv / 1e6:.1f} MB, padding "
              f"{pd / 1e6:.2f} MB  {tag}")
        check(ms >= b_ms, f"pool {pid}: pg_finish_ladder's graph replay "
              f"{ms:.4f} ms at or above its bound {b_ms:.4f} ms")
        pools[pid] = {"shape": shape, "ms": ms, "host_ms": host,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "launches": launches,
                      "build_operands_ms": build_s * 1e3,
                      "tail_mb": mv / 1e6, "padding_mb": pd / 1e6}
    print(f"the tail's tables at e4 (each pool at its own width): "
          f"{moved / 1e6:.1f} MB through the engine, {pad / 1e6:.2f} MB of "
          f"it ({pad / moved:.2%}) cells past their pool's size  {tag}")
    check(pad / moved < 0.10, "the tail's padding under 10% at e4")
    # the first layout: pool 1 at the one width of the epoch's pools,
    # timed with the first kernel (ab_ladder.cu) and this one in turns
    width, pairs = pk.pool_widths(m4)
    op12 = pk.build_operands(m4, 1, m4.pools[1], mp._raw[1], mp._pps[1],
                             width=width, pairs=pairs)
    shared_mv, shared_pd = 0, 0
    for pid, pool in m4.pools.items():
        op_s = op12 if pid == 1 else pk.build_operands(
            m4, pid, pool, mp._raw[pid], mp._pps[pid], width=width,
            pairs=pairs)
        packed_s = pk.normalize_packed(prev[pid][0], prev[pid][1], width)
        mv, pd = ladder_padding(op_s, packed_s, int(pool.size))
        shared_mv, shared_pd = shared_mv + mv, shared_pd + pd
    print(f"(one width W={width} for both pools, as before: "
          f"{shared_mv / 1e6:.1f} MB, {shared_pd / 1e6:.1f} MB of it "
          f"({shared_pd / shared_mv:.1%}) padding)  {tag}")
    import ab_kernels
    first = ab_kernels.ladder_variants(
        on_card(op12, dev), card=tag, first_only=True)
    summary["pg_finish_pools"] = pools
    summary["tail_mb"], summary["tail_padding_mb"] = moved / 1e6, pad / 1e6
    summary["shared_width_tail_mb"] = shared_mv / 1e6
    summary["shared_width_padding_mb"] = shared_pd / 1e6
    summary["ladder_variants"] = first
    p1 = pools[1]
    rows = [{"name": "pg_finish_ladder", "route": "cuda",
             "source": "ceph_tpu_torch/csrc/placement.cu",
             "replaces": "ceph_tpu/ops/placement_kernel.py:67",
             "launches": sum(ladder_launches),
             "launches_per_epoch": ladder_launches, "max_abs_err": max_err,
             "matches_plain": max_err == 0, "ms": p1["ms"],
             "host_ms": p1["host_ms"], "plain_ms": p1["plain_ms"],
             "bound_ms": p1["bound_ms"], "bound_by": p1["bound_by"],
             "library_ms": None, "shape": p1["shape"],
             "pools": {str(k): v for k, v in pools.items()},
             "first_version_ms": {k: v["ms"] for k, v in first.items()}}]
    rows.append(words_row(dev, m4, words_launches))
    return summary, rows, {"ctx": ctx, "map": m4}


def _cluster_counters(osds) -> dict:
    """The EC data path's perf counters summed over the OSDs."""
    names = ("ec_dispatch_submits", "ec_decode_submits",
             "recovery_decode_stripes", "recovery_pulls")
    return {n: sum(o.perf.dump().get(n, 0) for o in osds) for n in names}


def _wait_active(c, pool: int, pg_num: int, timeout: float) -> float:
    """Seconds until every PG of the pool is active on its primary (the
    peering that follows a map change); raises past ``timeout``."""
    from ceph_tpu_torch.osd.pg import STATE_ACTIVE
    t0 = time.perf_counter()
    while True:
        active = sum(1 for o in list(c.osds.values())
                     for pgid, pg in list(o.pgs.items())
                     if pgid[0] == pool and pg.primary == o.osd_id
                     and pg.state == STATE_ACTIVE)
        if active == pg_num:
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            raise SmokeFailure(f"{active}/{pg_num} PGs of pool {pool} "
                               f"active after {timeout} s")
        time.sleep(0.1)


def _rados_bench(names, submit, done) -> float:
    """rados bench's loop: CLUSTER_IN_FLIGHT ops outstanding, the oldest
    waited for first; ``done(name, completion)`` checks each.  Seconds by
    the host clock, first submit to last completion."""
    from collections import deque
    pending: deque = deque()
    t0 = time.perf_counter()

    def finish(name, comp):
        if not comp.wait_for_complete(CLUSTER_OP_TIMEOUT) \
                or comp.get_return_value() != 0:
            raise SmokeFailure(f"cluster op on {name} failed: "
                               f"rc {comp.get_return_value()}")
        done(name, comp)

    for name in names:
        if len(pending) >= CLUSTER_IN_FLIGHT:
            finish(*pending.popleft())
        pending.append((name, submit(name)))
    while pending:
        finish(*pending.popleft())
    return time.perf_counter() - t0


def _shard_placement(c, pool: int, names, deep: bool) -> tuple[list, int]:
    """(object, shard, osd) of every shard that is not on the OSD the
    mon's map names with its hinfo matching (``deep``), or not there at
    all (``deep`` off: existence and an hinfo attribute only); and the
    count of positions the map leaves without an OSD (chooseleaf indep
    can leave a hole when the pool's width equals the OSDs in)."""
    from ceph_tpu_torch.client.rados import ceph_str_hash_rjenkins
    from ceph_tpu_torch.osd.ec_util import HashInfo
    from ceph_tpu_torch.osd.osdmap import CEPH_NOSD, pg_to_pgid
    m = c.mon.osdmap
    bad, holes = [], 0
    for name in names:
        pg = pg_to_pgid(ceph_str_hash_rjenkins(name), m.pools[pool].pg_num)
        up = m.pg_to_up_acting_osds(pool, pg)[0]
        cid = f"{pool}.{pg}"
        for s, osd_id in enumerate(up):
            if osd_id == CEPH_NOSD:
                holes += 1
                continue
            osd = c.osds.get(osd_id)
            soid = f"{name}:{s}"
            try:
                hinfo = osd.store.getattr(cid, soid, "hinfo")
                ok = hinfo is not None and (
                    not deep or HashInfo.matches(osd.store.read(cid, soid),
                                                 hinfo))
            except (KeyError, AttributeError):
                ok = False
            if not ok:
                bad.append((name, s, osd_id))
    return bad, holes


def _data_holes(c, pool: int, names, k: int) -> list:
    """The objects whose PG the mon's map leaves without an OSD at a data
    position (shard < k): a read of one must decode."""
    from ceph_tpu_torch.client.rados import ceph_str_hash_rjenkins
    from ceph_tpu_torch.osd.osdmap import CEPH_NOSD, pg_to_pgid
    m = c.mon.osdmap
    out = []
    for name in names:
        pg = pg_to_pgid(ceph_str_hash_rjenkins(name), m.pools[pool].pg_num)
        if CEPH_NOSD in m.pg_to_up_acting_osds(pool, pg)[0][:k]:
            out.append(name)
    return out


def _check_shards(stores, osdmap, pool: int, name: str, full, k: int,
                  what: str) -> int:
    """One object's stored shards on the OSDs the map names == the shard
    columns of ``full`` (its (stripes, k + m, su) stripes and parity),
    each with a matching hinfo; ``stores`` maps an OSD id to its store.
    Returns the shards held."""
    from ceph_tpu_torch.client.rados import ceph_str_hash_rjenkins
    from ceph_tpu_torch.osd.ec_util import HashInfo, StripeInfo
    from ceph_tpu_torch.osd.osdmap import CEPH_NOSD, pg_to_pgid
    si = StripeInfo(k, CLUSTER_STRIPE_UNIT)
    pg = pg_to_pgid(ceph_str_hash_rjenkins(name), osdmap.pools[pool].pg_num)
    held = 0
    for s, osd_id in enumerate(osdmap.pg_to_up_acting_osds(pool, pg)[0]):
        if osd_id == CEPH_NOSD:
            continue
        store = stores[osd_id]
        blob = store.read(f"{pool}.{pg}", f"{name}:{s}")
        if blob != si.shard_column(full, s).tobytes() or not \
                HashInfo.matches(blob, store.getattr(
                    f"{pool}.{pg}", f"{name}:{s}", "hinfo")):
            raise SmokeFailure(f"{name} shard {s} on osd.{osd_id} != "
                               f"{what} (or its hinfo)")
        held += 1
    return held


def _oracle_shards(c, pool: int, name: str, payload: bytes, gen,
                   k: int) -> None:
    """One object's stored shards on the OSDs the map names == the numpy
    oracle's encode of its payload, each with a matching hinfo."""
    import numpy as np

    from ceph_tpu_torch.ops.gf_kernel import ec_encode_ref
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    stripes = StripeInfo(k, CLUSTER_STRIPE_UNIT).split(
        np.frombuffer(payload, dtype=np.uint8))
    full = np.concatenate([stripes, ec_encode_ref(gen[k:], stripes)], axis=1)
    _check_shards({i: o.store for i, o in c.osds.items()}, c.mon.osdmap,
                  pool, name, full, k, "the numpy oracle's encode")


def bench_phase(c, io, pool: int, contexts, dev, tag: str, obj_bytes: int,
                subs: dict) -> dict:
    """10e: rados bench (the port's ObjBencher) on phase 10's healed
    cluster: write_bench, then seq_read_bench and rand_read_bench of what
    it wrote, each with the launch counts at 0 just before it and read just
    after; CLUSTER_SAMPLE of its objects, drawn with a seed, read back and
    their shards held against their stripes and gf_matvec's plain version
    on ``dev``.  The objects stay: an EC pool takes no delete (the OSD
    answers -22, as the reference's does)."""
    import numpy as np
    import torch

    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import gf_kernel as gk
    from ceph_tpu_torch.tools.rados_bench import ObjBencher
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    k, m = CLUSTER_K, CLUSTER_M
    b = ObjBencher(io, obj_size=obj_bytes, concurrent=CLUSTER_IN_FLIGHT,
                   run_name=BENCH_RUN_NAME, op_timeout=CLUSTER_OP_TIMEOUT)
    runs: dict = {}
    launches: dict = {}

    def run(mode, body):
        _build.reset_launches()
        res = body()
        if on_card:
            torch.cuda.synchronize()
        gf = _build.LAUNCHES["gf_matvec"]
        res["gf_matvec_launches"] = gf
        runs[mode] = res
        launches[f"10e_{mode}"] = gf
        print(f"cluster 10e {mode}: {json.dumps(res)}  {tag}")
        check(res["errors"] == 0 and res["total_writes_or_reads"] > 0,
              f"10e {mode}: {res['total_writes_or_reads']} ops, errors 0")
        return res

    w = run("write", lambda: b.write_bench(BENCH_WRITE_S))
    n = w["total_writes_or_reads"]
    check(not on_card or launches["10e_write"] >= 1,
          f"10e: gf_matvec launched by the writes ({launches['10e_write']})")
    run("seq", lambda: b.seq_read_bench(BENCH_READ_S, n))
    run("rand", lambda: b.rand_read_bench(BENCH_READ_S, n))
    print(f"cluster 10e: rados bench MB/s write "
          f"{runs['write']['bandwidth_mb_s']:.1f}, seq "
          f"{runs['seq']['bandwidth_mb_s']:.1f}, rand "
          f"{runs['rand']['bandwidth_mb_s']:.1f}; beside 10a's write "
          f"{subs['10a_write']['MB_s']:.1f} and 10b's read "
          f"{subs['10b_read']['MB_s']:.1f} (host clock)  {tag}")
    payload = b.payload()
    tab = torch.from_numpy(gk.pack_rows(_ec_generator(k, m)[k:][None])) \
        .to(dev)
    rng = np.random.default_rng(21)
    sample = [f"{BENCH_RUN_NAME}_{i}" for i in
              sorted(rng.choice(n, min(CLUSTER_SAMPLE, n), replace=False))]
    stores = {i: o.store for i, o in c.osds.items()}
    held = 0
    for name in sample:
        if io.read(name) != payload:
            raise SmokeFailure(f"10e: {name} read back != the bench payload")
        held += _plain_shards(stores, c.mon.osdmap, pool, name, payload,
                              tab, k, m, dev)
    check(True, f"10e: {len(sample)} sampled bench objects read back "
          f"byte-equal; their {held} shards on the OSDs the map names == "
          f"their stripes and gf_matvec's plain version on the card, hinfo "
          f"matching")
    for ctx in contexts:
        assert_no_faults(f"10e: {ctx.name}", ctx.fault_digest())
    secs = time.perf_counter() - t0
    print(f"cluster 10e: took {secs:.1f} s  {tag}")
    return {"runs": runs, "objects": n, "sample": sample,
            "shards_held": held, "launches": launches,
            "phase_seconds": secs}


def cluster_phase(dev, tag: str, n_objects: int = CLUSTER_OBJECTS,
                  obj_bytes: int = CLUSTER_OBJ_BYTES,
                  scrub: bool = True) -> tuple:
    """Phase 10: the OSD data path on a MiniCluster (see the docstring),
    then (``scrub``) phase 11 on the same cluster.  Returns the
    {"cluster": ...} summary, gf_matvec's launches by sub-phase with its
    time at one object's stripes, and phase 11's (summary, kernels row) or
    None."""
    import threading

    import numpy as np
    import torch

    from ceph_tpu_torch.ops import _build, telemetry
    from ceph_tpu_torch.ops import gf_kernel as gk
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.tools.vstart import MiniCluster
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    if n_objects < CLUSTER_FULL_OBJECTS:
        print(f"cluster: object count cut from {CLUSTER_FULL_OBJECTS} to "
              f"{n_objects}: at {CLUSTER_FULL_OBJECTS} the phase passed its "
              f"{CLUSTER_BUDGET_S:.0f} s budget (10d's recovery)")
    telemetry.reset()
    mem0 = torch.cuda.memory_allocated() if on_card else 0
    names = [f"bench_{i:04d}" for i in range(n_objects)]
    payload = _payloads(dev, names, obj_bytes, 10)
    total_mb = n_objects * obj_bytes / 1e6
    c = MiniCluster(n_osds=CLUSTER_OSDS, ms_type="loopback",
                    store_type="memstore", device=dev).start()
    contexts = []
    client = io = None
    peer_s = None
    subs: dict = {}
    launches: dict = {}
    scrubbed = None
    try:
        c.wait_for_osd_count(CLUSTER_OSDS, timeout=CLUSTER_OP_TIMEOUT)
        client = c.client(timeout=CLUSTER_OP_TIMEOUT)
        contexts = [c.mon.ctx, client.ctx] + [o.ctx for o in c.osds.values()]
        pool = c.create_pool(client, pool_type="erasure", plugin="jerasure",
                             technique="reed_sol_van", k=CLUSTER_K,
                             m=CLUSTER_M, pg_num=CLUSTER_PG_NUM,
                             epoch_timeout=CLUSTER_OP_TIMEOUT)
        peer_s = _wait_active(c, pool, CLUSTER_PG_NUM, CLUSTER_OP_TIMEOUT)
        print(f"cluster: pool created, all {CLUSTER_PG_NUM} PGs active "
              f"{peer_s:.1f} s later (each daemon maps the pool with the "
              f"scalar rule engine and peers every PG)  {tag}")
        io = client.open_ioctx(pool)
        k = CLUSTER_K
        gen = _ec_generator(k, CLUSTER_M)
        print(f"cluster: {CLUSTER_OSDS} OSDs (memstore, loopback), 1 mon, "
              f"pool {pool} jerasure reed_sol_van k={k} m={CLUSTER_M} "
              f"pg_num {CLUSTER_PG_NUM} stripe_unit {CLUSTER_STRIPE_UNIT}; "
              f"{n_objects} objects of {obj_bytes} B, {CLUSTER_IN_FLIGHT} in "
              f"flight  {tag}")

        def sub_phase(label, body):
            live = list(c.osds.values())
            before = _cluster_counters(live)
            telemetry.dispatch_stats().clear()
            telemetry.decode_dispatch_stats().clear()
            _build.reset_launches()
            secs = body()
            if on_card:
                torch.cuda.synchronize()
            gf = _build.LAUNCHES["gf_matvec"]
            after = _cluster_counters(c.osds.values())
            moved = {n: after[n] - before[n] for n in after}
            rec = {"objects": n_objects, "seconds": secs,
                   "MB_s": total_mb / secs, "gf_matvec_launches": gf,
                   "counters": moved,
                   "encode_phases": telemetry.dispatch_stats()
                   .phases.summary(),
                   "decode_phases": telemetry.decode_dispatch_stats()
                   .phases.summary()}
            subs[label] = rec
            launches[label] = gf
            print(f"cluster {label}: {total_mb:.1f} MB in {secs:.3f} s = "
                  f"{rec['MB_s']:.1f} MB/s (host clock); gf_matvec "
                  f"launches {gf}; {moved}  {tag}")
            for side in ("encode", "decode"):
                for fam, v in rec[f"{side}_phases"]["kernels"].items():
                    print(f"cluster {label}: {side} engines {fam}: "
                          f"{v['batches']} batches, seconds "
                          + ", ".join(f"{ph} {s:.4f}" for ph, s in
                                      v["seconds"].items()) + f"  {tag}")
            return rec

        def check_read(name, comp):
            if comp.reply.ops[0].data != payload[name]:
                raise SmokeFailure(f"{name} read back != the bytes written")

        def read_all():
            return _rados_bench(names, io.aio_read, check_read)

        # 10a: the writes
        sub_phase("10a_write", lambda: _rados_bench(
            names, lambda n: io.aio_write_full(n, payload[n]),
            lambda n, comp: None))
        check(not on_card or launches["10a_write"] >= 1,
              f"10a: gf_matvec launched by the writes "
              f"({launches['10a_write']})")
        sample = names[:: max(1, n_objects // CLUSTER_SAMPLE)][
            :CLUSTER_SAMPLE]
        for name in sample:
            _oracle_shards(c, pool, name, payload[name], gen, k)
        check(True, f"10a: {len(sample)} sampled objects' 12 shards on the "
              f"mapped OSDs == the numpy oracle's encode, hinfo matching")
        # 10b: the reads; a healthy read decodes only where it goes
        # without a data shard: each OSD counts why (dump_read_decodes),
        # and the map's NONE positions are counted beside it
        rec = sub_phase("10b_read", read_all)
        check(True, f"10b: all {n_objects} objects read back byte-equal")
        why: dict = {}
        for osd in c.osds.values():
            for reason, n in osd.ctx.admin.execute(
                    "dump_read_decodes").items():
                why[reason] = why.get(reason, 0) + n
        holes = _data_holes(c, pool, names, k)
        rec["decode_reasons"] = why
        rec["objects_with_a_data_hole"] = holes
        print(f"cluster 10b: reads that decoded went without data shards "
              f"for {why or 'no reason: none decoded'}; objects whose map "
              f"leaves a data position without an OSD: {holes}  {tag}")
        check(rec["counters"]["ec_decode_submits"] == len(holes)
              and set(why) <= {"no OSD at the position"},
              f"10b: every healthy read that decoded "
              f"({rec['counters']['ec_decode_submits']}) is an object whose "
              f"map leaves a data position without an OSD ({len(holes)})")
        # 10c: one OSD lost, every object read again
        c.kill_osd(CLUSTER_VICTIM)
        rc, out = client.mon_command({"prefix": "osd down",
                                      "id": str(CLUSTER_VICTIM)})
        check(rc == 0, f"osd down {CLUSTER_VICTIM}: {out}")
        epoch = c.mon.osdmap.epoch
        c.wait_for_epoch(epoch, timeout=CLUSTER_OP_TIMEOUT)
        client.wait_for_epoch(epoch)
        rec = sub_phase("10c_degraded_read", read_all)
        check(rec["counters"]["ec_decode_submits"] > 0
              and (not on_card or rec["gf_matvec_launches"] >= 1),
              f"10c: degraded reads decode through the decode channel "
              f"({rec['counters']['ec_decode_submits']} submits, "
              f"{rec['gf_matvec_launches']} gf_matvec launches); all "
              f"{n_objects} objects byte-equal")
        # 10d: a new OSD, the dead one out, the cluster heals
        def recover():
            t0 = time.perf_counter()
            c.run_osd(CLUSTER_OSDS)
            c.wait_for_osd_count(CLUSTER_OSDS, timeout=CLUSTER_OP_TIMEOUT)
            rc_, out_ = client.mon_command({"prefix": "osd out",
                                            "id": str(CLUSTER_VICTIM)})
            if rc_ != 0:
                raise SmokeFailure(f"osd out: {out_}")
            c.wait_for_epoch(c.mon.osdmap.epoch, timeout=CLUSTER_OP_TIMEOUT)
            deadline = time.time() + CLUSTER_RECOVERY_S
            while True:
                bad, holes = _shard_placement(c, pool, names, deep=False)
                if not bad:
                    bad, holes = _shard_placement(c, pool, names, deep=True)
                    if not bad:
                        subs["holes"] = holes
                        return time.perf_counter() - t0
                if time.time() > deadline:
                    raise SmokeFailure(
                        f"10d: {len(bad)} shards not on their mapped OSDs "
                        f"with a matching hinfo after {CLUSTER_RECOVERY_S} "
                        f"s, e.g. {bad[:4]}")
                time.sleep(0.25)
        rec = sub_phase("10d_recovery", recover)
        rec["map_holes"] = subs.pop("holes")
        contexts.append(c.osds[CLUSTER_OSDS].ctx)
        check(not on_card or rec["gf_matvec_launches"] >= 1,
              f"10d: every object's shards on the OSDs the new map names "
              f"with matching hinfo in {rec['seconds']:.3f} s "
              f"({rec['map_holes']} of {n_objects * (k + CLUSTER_M)} "
              f"positions the map leaves without an OSD); gf_matvec "
              f"launched {rec['gf_matvec_launches']} times")
        for name in sample:
            _oracle_shards(c, pool, name, payload[name], gen, k)
        t0 = time.perf_counter()
        read_all()
        subs["10d_recovery"]["reread_MB_s"] = total_mb / (
            time.perf_counter() - t0)
        check(True, f"10d: all {n_objects} objects byte-equal after "
              f"recovery ({subs['10d_recovery']['reread_MB_s']:.1f} MB/s); "
              f"sample == the oracle again")
        if scrub:
            print("== 11. deep scrub on the MiniCluster")
            scrubbed = scrub_phase(c, client, pool, names, dev, tag,
                                   obj_bytes)
        # 10e after phase 11: an EC pool takes no delete, so the bench's
        # objects stay, and phase 11 scrubs what it scrubbed before
        bench = bench_phase(c, io, pool, contexts, dev, tag, obj_bytes,
                            subs)
        launches.update(bench["launches"])
        subs["10e_rados_bench"] = bench
        # the card's busy share over degraded reads of a few objects
        if on_card:
            few = names[:CLUSTER_BUSY_OBJECTS]
            c.kill_osd(CLUSTER_OSDS)
            rc, _ = client.mon_command({"prefix": "osd down",
                                        "id": str(CLUSTER_OSDS)})
            c.wait_for_epoch(c.mon.osdmap.epoch, timeout=CLUSTER_OP_TIMEOUT)
            client.wait_for_epoch(c.mon.osdmap.epoch)
            busy = _busy(lambda: _rados_bench(few, io.aio_read, check_read),
                         lambda: None)
            subs["busy_degraded_read"] = {
                "objects": len(few), "busy_share": busy["busy_share"],
                "window_ms": busy["window_ms"], "busy_ms": busy["busy_ms"],
                "complete": busy["complete"]}
            print(f"cluster: card busy share over degraded reads of "
                  f"{len(few)} objects: "
                  + (f"{busy['busy_share']:.4f}" if busy["busy_share"]
                     is not None else "not measured")
                  + f" (window {busy['window_ms']:.1f} ms)  {tag}")
        # the kernel at one object's stripes, against its plain version
        si = StripeInfo(k, CLUSTER_STRIPE_UNIT)
        stripes = torch.from_numpy(si.split(np.frombuffer(
            payload[names[0]], dtype=np.uint8))).to(dev)
        tab = torch.from_numpy(gk.pack_rows(gen[k:][None])).to(dev)
        pidx = torch.zeros((stripes.shape[0],), dtype=torch.int32,
                           device=dev)
        got = gk.gf_matvec(tab, pidx, stripes, CLUSTER_M)
        want = gk.gf_matvec_plain(tab, pidx, stripes, CLUSTER_M)
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"gf_matvec == plain torch on one object's "
              f"{tuple(stripes.shape)} stripes")
        for ctx in contexts:
            assert_no_faults(f"10: {ctx.name}", ctx.fault_digest())
        gf_row = {"launches_by_sub_phase": launches, "max_abs_err": err,
                  "shape": f"{tuple(stripes.shape)} -> "
                           f"({stripes.shape[0]}, {CLUSTER_M}, "
                           f"{stripes.shape[2]})"}
        if on_card:
            out_ = torch.empty_like(got)
            ms = graph_ms(lambda: launch_gf(tab, pidx, stripes, out_), 20)
            b_ms, b_by = gf_work(stripes.shape[0], k, CLUSTER_M,
                                 stripes.shape[2], tab.nbytes)
            gf_row.update(ms=ms, bound_ms=b_ms, bound_by=b_by)
            print(f"gf_matvec       cluster object {gf_row['shape']} kernel "
                  f"{ms:.4f} ms (graph replay)  bound {b_ms:.4f} ms "
                  f"({b_by})  {tag}")
    finally:
        c.stop()
    # the daemons' contexts (their codecs' tables on the card) go with them;
    # their engines' threads are named after them ("osd.3-dispatch-...")
    ctx_names = {ctx.name for ctx in contexts}
    c = client = io = contexts = None
    gc.collect()
    deadline = time.time() + 10
    alive = []
    while time.time() < deadline:
        alive = [t.name for t in threading.enumerate() if t.is_alive()
                 and t.name.split("-")[0] in ctx_names]
        if not alive:
            break
        time.sleep(0.05)
    mem = torch.cuda.memory_allocated() if on_card else 0
    print(f"cluster: after stop(): {threading.active_count()} threads alive, "
          f"engine threads of the cluster's {len(ctx_names)} contexts "
          f"{alive or 'none'}; torch.cuda.memory_allocated() {mem} B "
          f"({mem - mem0:+d} B against the phase's start)  {tag}")
    check(not alive, "after stop(): no engine thread alive")
    secs = time.perf_counter() - t_phase
    if scrubbed is not None:
        secs -= scrubbed[0]["phase_seconds"]
    bench_s = subs.get("10e_rados_bench", {}).get("phase_seconds", 0.0)
    secs -= bench_s
    print(f"cluster: phase 10 took {secs:.1f} s without 10e's "
          f"{bench_s:.1f} s (budget {CLUSTER_BUDGET_S:.0f} s)  {tag}")
    summary = {"osds": CLUSTER_OSDS, "k": CLUSTER_K, "m": CLUSTER_M,
               "pg_num": CLUSTER_PG_NUM, "objects": n_objects,
               "pool_peering_seconds": peer_s,
               "object_bytes": obj_bytes, "in_flight": CLUSTER_IN_FLIGHT,
               "sub_phases": subs, "phase_seconds": secs,
               "cuda_memory_allocated_after_stop": mem,
               "cuda_memory_allocated_delta": mem - mem0}
    return summary, gf_row, scrubbed


class _DigestTap:
    """Phase 11's instrumentation: every scrub_digest batch the engines
    run (its card tensors and its host lengths, kept for the checks after
    each pass) and every row the scrubs read.  It wraps
    ``checksum_kernel.scrub_digest_batched`` (the channel's fn calls it by
    module attribute) and ``OSDDaemon._scrub_read_rows``; ``close()`` puts
    both back."""

    def __init__(self):
        import threading

        import numpy as np

        from ceph_tpu_torch.ops import checksum_kernel as ck
        from ceph_tpu_torch.ops.dispatch import launch_host_aux
        from ceph_tpu_torch.osd.daemon import OSDDaemon
        self._ck, self._daemon = ck, OSDDaemon
        self._digest = ck.scrub_digest_batched
        self._read = OSDDaemon._scrub_read_rows
        self._lock = threading.Lock()
        self.batches: list = []
        self.rows_read = 0
        self.bytes_read = 0
        tap = self

        def digest(data, mats, invp, lens=None):
            out = tap._digest(data, mats, invp, lens=lens)
            aux = launch_host_aux()
            lens = np.array(aux[0], dtype=np.int64) if aux else None
            with tap._lock:
                tap.batches.append((data, mats, invp, out, lens))
            return out

        def read_rows(osd, *a, **kw):
            out, rows, vers = tap._read(osd, *a, **kw)
            with tap._lock:
                tap.rows_read += 2 * len(rows)
                tap.bytes_read += sum(len(r[1]) + len(r[2]) for r in rows)
            return out, rows, vers

        ck.scrub_digest_batched = digest
        OSDDaemon._scrub_read_rows = read_rows

    def reset(self) -> None:
        with self._lock:
            self.batches = []
            self.rows_read = 0
            self.bytes_read = 0

    def close(self) -> None:
        self._ck.scrub_digest_batched = self._digest
        self._daemon._scrub_read_rows = self._read

    def check(self, where: str) -> int:
        """Every batch since the last reset: the kernel's output == the
        plain version on the card (batches of one width stacked into one
        plain call), and its crc column == zlib.crc32 of each unpadded
        row on the host.  Returns the batches checked."""
        import zlib

        import numpy as np
        import torch
        torch.cuda.synchronize()
        by_w: dict = {}
        for b in self.batches:
            by_w.setdefault(int(b[0].shape[1]), []).append(b)
        for w, bs in sorted(by_w.items()):
            data = torch.cat([b[0] for b in bs])
            want = self._ck.scrub_digest_plain(
                data, torch.cat([b[1] for b in bs]),
                torch.cat([b[2] for b in bs]))
            got = torch.cat([b[3] for b in bs])
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            check(same, f"{where}: scrub_digest == plain torch on all "
                  f"{len(bs)} batches of width {w} ({data.shape[0]} rows)")
            host = data.cpu().numpy()
            crc = got.cpu().numpy()[:, 0]
            lens = np.concatenate([b[4] for b in bs])
            bad = [i for i in range(host.shape[0])
                   if zlib.crc32(host[i, :lens[i]].tobytes()) != crc[i]]
            check(not bad, f"{where}: crc column == zlib.crc32 of each "
                  f"unpadded row of width {w} on the host ({bad[:4]})")
        return len(self.batches)


def scrub_phase(c, client, ec_pool: int, ec_names, dev, tag: str,
                obj_bytes: int = CLUSTER_OBJ_BYTES) -> tuple:
    """Phase 11: deep scrub on phase 10's MiniCluster (see the docstring).
    Returns the {"scrub": ...} summary and scrub_digest's kernels row."""
    import threading

    import torch

    from ceph_tpu_torch.client.rados import ceph_str_hash_rjenkins
    from ceph_tpu_torch.objectstore import Transaction
    from ceph_tpu_torch.ops import _build, telemetry
    from ceph_tpu_torch.osd.osdmap import CEPH_NOSD, pg_to_pgid
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    look0 = telemetry.mapping_summary()
    rpool = c.create_pool(client, epoch_timeout=CLUSTER_OP_TIMEOUT)
    p = c.mon.osdmap.pools[rpool]
    check(p.size == SCRUB_REP_SIZE and p.pg_num == SCRUB_REP_PG_NUM,
          f"11: replicated pool {rpool} at the defaults: size {p.size}, "
          f"pg_num {p.pg_num}")
    peer_s = _wait_active(c, rpool, SCRUB_REP_PG_NUM, CLUSTER_OP_TIMEOUT)
    look1 = telemetry.mapping_summary()
    lookups = {k: look1[k] - look0[k] for k in ("lookups",
                                                 "lookup_fallbacks")}
    print(f"scrub: the pool's map epoch: {lookups['lookups']} PG lookups "
          f"on the daemons' mapping services, {lookups['lookup_fallbacks']} "
          f"of them served by the scalar oracle  {tag}")
    gen_ = torch.Generator(device=dev).manual_seed(11)
    names = [f"rbench_{i:04d}" for i in range(SCRUB_REP_OBJECTS)]
    block = torch.randint(0, 256, (len(names), obj_bytes), dtype=torch.uint8,
                          device=dev, generator=gen_).cpu().numpy()
    payload = {n: block[i].tobytes() for i, n in enumerate(names)}
    rio = client.open_ioctx(rpool)
    write_s = _rados_bench(names, lambda n: rio.aio_write_full(
        n, payload[n]), lambda n, comp: None)
    print(f"scrub: replicated pool {rpool} (size {SCRUB_REP_SIZE}, pg_num "
          f"{SCRUB_REP_PG_NUM}) active {peer_s:.1f} s after create; "
          f"{len(names)} objects of {obj_bytes} B written in {write_s:.2f} s"
          f"  {tag}")
    osds = list(c.osds.values())
    tap = _DigestTap()
    passes: dict = {}

    def sweep() -> list:
        out = [None] * len(osds)

        def one(i):
            out[i] = osds[i].scrub_all_pgs()
        th = [threading.Thread(target=one, args=(i,)) for i in range(len(osds))]
        for t in th:
            t.start()
        for t in th:
            t.join()
        return out

    def run_pass(label: str, busy: bool = False) -> dict:
        tap.reset()
        telemetry.scrub_stats().clear()
        _build.reset_launches()
        box: dict = {}

        def go():
            t0 = time.perf_counter()
            box["aggs"] = sweep()
            if on_card:
                torch.cuda.synchronize()
            box["secs"] = time.perf_counter() - t0
        prof = None
        if busy and on_card:
            prof = _busy(go, lambda: None, tries=1)
        else:
            go()
        launches = dict(_build.LAUNCHES)
        aggs, secs = box["aggs"], box["secs"]
        st = telemetry.scrub_summary()
        rec = {"seconds": secs, "pgs": sum(a["pgs"] for a in aggs),
               "checked": sum(a["checked"] for a in aggs),
               "inconsistent": sorted(o for a in aggs
                                      for o in a["inconsistent"]),
               "repaired": sorted(list(r) for a in aggs
                                  for r in a["repaired"]),
               "repair_unverified": sorted(list(r) for a in aggs
                                           for r in a["repair_unverified"]),
               "missing_peers": sorted({o for a in aggs
                                        for o in a["missing_peers"]}),
               "clean": all(a["clean"] for a in aggs),
               "errors": [e for a in aggs for e in a.get("errors", ())],
               "rows_read": tap.rows_read, "MB_read": tap.bytes_read / 1e6,
               "MB_s": tap.bytes_read / 1e6 / secs,
               "scrub_digest_launches": launches["scrub_digest"],
               "gf_matvec_launches": launches["gf_matvec"],
               "digest_batches": st["digest_batches"],
               "digest_rows": st["batched_digest_objects"],
               "scalar_batches": st["scalar_fallback_batches"]}
        if prof is not None:
            rec["busy_share"] = prof["busy_share"]
            rec["busy_window_ms"] = prof["window_ms"]
        rec["batches_checked"] = tap.check(f"11 {label}") if on_card else 0
        passes[label] = rec
        print(f"scrub {label}: {rec['pgs']} PGs, {rec['checked']} objects, "
              f"{rec['MB_read']:.1f} MB read and digested in {secs:.3f} s = "
              f"{rec['MB_s']:.1f} MB/s (host clock); scrub_digest launches "
              f"{rec['scrub_digest_launches']}, gf_matvec "
              f"{rec['gf_matvec_launches']}; {rec['digest_batches']} digest "
              f"batches, {rec['digest_rows']} rows on the card of "
              f"{rec['rows_read']} read, {rec['scalar_batches']} host-loop "
              f"batches; inconsistent {rec['inconsistent']}, repaired "
              f"{rec['repaired']}"
              + (f"; card busy share {rec['busy_share']}" if "busy_share"
                 in rec else "") + f"  {tag}")
        check(not rec["errors"] and not rec["missing_peers"],
              f"11 {label}: every peer reported, no scrub error "
              f"({rec['errors'][:2]}, {rec['missing_peers']})")
        check(rec["pgs"] == CLUSTER_PG_NUM + SCRUB_REP_PG_NUM,
              f"11 {label}: every PG of both pools scrubbed by its primary")
        check(rec["digest_rows"] == rec["rows_read"] > 0
              and rec["scalar_batches"] == 0
              and (not on_card or rec["scrub_digest_launches"] > 0),
              f"11 {label}: all {rec['rows_read']} rows read digested on "
              f"the card, none by the host loop, scrub_digest launched")
        for osd in c.osds.values():
            assert_no_faults(f"11 {label}: {osd.ctx.name}",
                             osd.ctx.fault_digest())
        return rec

    try:
        p1 = run_pass("11a_clean", busy=True)
        check(p1["clean"] and not p1["inconsistent"],
              "11a: every PG of both pools scrubs clean")
        # 11b: one replica's object and one EC shard corrupted at the store
        m = c.mon.osdmap
        victim_obj = names[3]
        pg = pg_to_pgid(ceph_str_hash_rjenkins(victim_obj),
                        m.pools[rpool].pg_num)
        up, primary = m.pg_to_up_acting_osds(rpool, pg)[:2]
        rep_osd = next(o for o in up if o != primary and o != CEPH_NOSD)
        rcid = f"{rpool}.{pg}"
        c.osds[rep_osd].store.apply_transaction(
            Transaction().truncate(rcid, victim_obj, 0)
            .write(rcid, victim_obj, 0, bytes(obj_bytes)))
        ec_obj = ec_names[7]
        pg = pg_to_pgid(ceph_str_hash_rjenkins(ec_obj),
                        m.pools[ec_pool].pg_num)
        up, primary = m.pg_to_up_acting_osds(ec_pool, pg)[:2]
        shard = next(s for s, o in enumerate(up)
                     if o != primary and o != CEPH_NOSD)
        ec_osd = up[shard]
        ecid, soid = f"{ec_pool}.{pg}", f"{ec_obj}:{shard}"
        good = c.osds[ec_osd].store.read(ecid, soid)
        c.osds[ec_osd].store.apply_transaction(
            Transaction().truncate(ecid, soid, 0)
            .write(ecid, soid, 0, bytes(b ^ 0x5A for b in good)))
        print(f"scrub 11b: corrupted {victim_obj} on osd.{rep_osd} (a "
              f"replica) and shard {soid} on osd.{ec_osd}  {tag}")
        p2 = run_pass("11b_corrupt")
        check(p2["inconsistent"] == sorted([victim_obj, soid])
              and p2["repaired"] == sorted([[victim_obj, rep_osd],
                                            [soid, ec_osd]])
              and not p2["repair_unverified"],
              f"11b: exactly the two corruptions found inconsistent, "
              f"repaired and verified ({p2['inconsistent']}, "
              f"{p2['repaired']}, unverified {p2['repair_unverified']})")
        check(c.osds[rep_osd].store.read(rcid, victim_obj)
              == payload[victim_obj]
              and c.osds[ec_osd].store.read(ecid, soid) == good
              and (not on_card or p2["gf_matvec_launches"] > 0),
              "11b: both copies hold their original bytes again, the EC "
              "shard rebuilt through gf_matvec")
        p3 = run_pass("11c_clean_again")
        check(p3["clean"] and not p3["inconsistent"],
              "11c: a third pass is clean")
    finally:
        tap.close()
    launches = p1["scrub_digest_launches"]
    kernel_row = digest_row(dev, tag, on_card)
    kernel_row.update(launches=launches, launches_by_pass={
        k: v["scrub_digest_launches"] for k, v in passes.items()})
    secs = time.perf_counter() - t_phase
    print(f"scrub: phase 11 took {secs:.1f} s (budget {SCRUB_BUDGET_S:.0f} "
          f"s)  {tag}")
    summary = {"replicated_pool": {"size": SCRUB_REP_SIZE,
                                   "pg_num": SCRUB_REP_PG_NUM,
                                   "objects": len(names),
                                   "object_bytes": obj_bytes,
                                   "peering_seconds": peer_s,
                                   "peering_lookups": lookups,
                                   "write_seconds": write_s},
               "ec_pool": {"k": CLUSTER_K, "m": CLUSTER_M,
                           "pg_num": CLUSTER_PG_NUM,
                           "objects": len(ec_names),
                           "shard_bytes": obj_bytes // CLUSTER_K},
               "passes": passes, "phase_seconds": secs}
    return summary, kernel_row


def digest_row(dev, tag: str, on_card: bool) -> dict:
    """scrub_digest alone at DIGEST_SHAPES, each held against its plain
    version on the same card inputs (exact), timed by graph replay beside
    the launches issued from Python, beside two bounds: the padded rows'
    bytes (S*W, as the first version was measured) and the bytes the
    lengths need (each row up to its length, in 32-byte sectors).  Returns the kernels row: its headline numbers at the
    first shape, every shape under "shapes"."""
    import numpy as np
    import torch

    from ceph_tpu_torch.ops import checksum_kernel as ck
    from ceph_tpu_torch.ops import digest_cuda as dc
    rng = np.random.default_rng(11)
    shapes, err = [], 0
    for label, s, w, omap in DIGEST_SHAPES:
        if not on_card:     # a rehearsal on the CPU: narrow rows
            w = min(w, 1 << 12)
        b = digest_batch(dev, rng, s, w, omap)
        args = (b["data"], b["mats"], b["invp"])
        got = ck.scrub_digest_batched(*args, lens=b["lens"])
        want = ck.scrub_digest_plain(*args)
        e = int((got.view(torch.int32).long()
                 - want.view(torch.int32).long()).abs().max())
        err = max(err, e)
        check(e == 0, f"scrub_digest == plain torch at {label}")
        row = {"shape": label, "S": s, "W": w}
        if on_card:
            run = dc.plan(s, w)[0]
            g, h = paired_times(lambda: dc.scrub_digest(*args, b["lens"]),
                                10)
            ops_bytes = (b["mats"].nbytes + b["invp"].nbytes
                         + b["lens"].nbytes + s * 8)
            # the rows' bytes up to their lengths, in the 32-byte sectors
            # the memory reads
            need = int(sum(-(-int(n) // 32) * 32 for n in b["lens_np"]))
            row.update(run=run, ms=statistics.median(g),
                       host_ms=statistics.median(h))
            row["plain_ms"] = time_ms(lambda: ck.scrub_digest_plain(*args),
                                      1, reps=3)
            row["bound_padded_ms"], _by = bound(s * w + ops_bytes, 0)
            row["bound_ms"], row["bound_by"] = bound(need + ops_bytes, 0)
            row["GB_s"] = s * w / row["ms"] / 1e6
            print(f"scrub_digest    {label} run {run} kernel {row['ms']:.4f} "
                  f"ms (graph replay; {row['host_ms']:.4f} issued) = "
                  f"{row['GB_s']:.1f} GB/s of padded rows  bound "
                  f"{row['bound_ms']:.4f} ms by the lengths, "
                  f"{row['bound_padded_ms']:.4f} ms padded ({row['bound_by']})"
                  f"  plain {row['plain_ms']:.2f} ms  {tag}")
            check(row["ms"] >= row["bound_ms"],
                  f"scrub_digest {label}: graph replay {row['ms']:.4f} ms at "
                  f"or above its bound {row['bound_ms']:.4f} ms")
        shapes.append(row)
    big = shapes[0]
    return {"name": "scrub_digest", "route": "cuda",
            "source": "ceph_tpu_torch/csrc/digest.cu",
            "replaces": "ceph_tpu/ops/checksum_kernel.py:286",
            "max_abs_err": err, "matches_plain": err == 0,
            "ms": big.get("ms"), "host_ms": big.get("host_ms"),
            "plain_ms": big.get("plain_ms"), "bound_ms": big.get("bound_ms"),
            "bound_padded_ms": big.get("bound_padded_ms"),
            "bound_by": big.get("bound_by"), "library_ms": None,
            "shape": big["shape"], "shapes": shapes}


def bluestore_payloads(dev, names, obj_bytes: int, seed: int) -> dict:
    """Objects made from ``seed`` on ``dev``, in thirds by index: 7-bit
    ASCII text (32..126), small integers 0..7 four fifths of them zero,
    random bytes."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for i, name in enumerate(names):
        kind = i % 3
        if kind == 0:
            row = torch.randint(32, 127, (obj_bytes,), dtype=torch.uint8,
                                device=dev, generator=gen)
        elif kind == 1:
            row = torch.randint(0, 8, (obj_bytes,), dtype=torch.uint8,
                                device=dev, generator=gen)
            row *= (torch.rand(obj_bytes, device=dev, generator=gen)
                    < 0.2).to(torch.uint8)
        else:
            row = torch.randint(0, 256, (obj_bytes,), dtype=torch.uint8,
                                device=dev, generator=gen)
        out[name] = row.cpu().numpy().tobytes()
    return out


class _BlueStoreTap:
    """Phase 12's instrumentation: every bluestore_data digest batch (its
    card tensors and host lengths) and every bitplane_pack batch (input and
    planes), kept for the checks after each sub-step.  It wraps
    ``checksum_kernel.bluestore_digest_batched`` (the channel's fn calls it
    by module attribute) and ``compression_kernel.bitplane_planes_batched``
    (``pack_planes`` calls it by module global); ``close()`` puts both
    back."""

    def __init__(self):
        import threading

        import numpy as np

        from ceph_tpu_torch.ops import checksum_kernel as ck
        from ceph_tpu_torch.ops import compression_kernel as bk
        from ceph_tpu_torch.ops.dispatch import launch_host_aux
        self._ck, self._bk = ck, bk
        self._digest = ck.bluestore_digest_batched
        self._planes = bk.bitplane_planes_batched
        self._lock = threading.Lock()
        self.digests: list = []
        self.packs: list = []
        tap = self

        def digest(data, mats, invp, lens=None):
            out = tap._digest(data, mats, invp, lens=lens)
            aux = launch_host_aux()
            host_lens = np.array(aux[0], dtype=np.int64) if aux else None
            with tap._lock:
                tap.digests.append((data, mats, invp, out, host_lens))
            return out

        def planes(batch):
            out = tap._planes(batch)
            with tap._lock:
                tap.packs.append((batch, out))
            return out

        ck.bluestore_digest_batched = digest
        bk.bitplane_planes_batched = planes

    def reset(self) -> None:
        with self._lock:
            self.digests, self.packs = [], []

    def close(self) -> None:
        self._ck.bluestore_digest_batched = self._digest
        self._bk.bitplane_planes_batched = self._planes

    def check(self, where: str) -> tuple[int, int, int]:
        """Every batch since the last reset: bitplane_pack == the plain
        version on the card; the digest == the plain version on the card
        and its crc column == zlib.crc32 of each stored payload (its row up
        to its length) on the host.  Returns (digest batches, their rows,
        pack batches); the largest difference goes to ``self.err``."""
        import zlib

        import torch
        torch.cuda.synchronize()
        err = 0
        for batch, out in self.packs:
            want = self._bk.bitplane_planes_plain(batch)
            err = max(err, int((out.long() - want.long()).abs().max())
                      if out.numel() else 0)
        check(err == 0, f"{where}: bitplane_pack == plain torch on all "
              f"{len(self.packs)} batches")
        rows, bad = 0, []
        for data, mats, invp, out, lens in self.digests:
            want = self._ck.scrub_digest_plain(data, mats, invp)
            e = int((out.view(torch.int32).long()
                     - want.view(torch.int32).long()).abs().max())
            err = max(err, e)
            host = data.cpu().numpy()
            crc = out.cpu().numpy()[:, 0]
            bad += [i for i in range(host.shape[0])
                    if zlib.crc32(host[i, :lens[i]].tobytes()) != crc[i]]
            rows += host.shape[0]
        check(err == 0 and not bad,
              f"{where}: every bluestore_data batch ({len(self.digests)}, "
              f"{rows} rows) == plain torch, its crc column == zlib.crc32 "
              f"of each stored payload on the host ({bad[:4]})")
        self.err = max(getattr(self, "err", 0), err)
        return len(self.digests), rows, len(self.packs)


def _stored_ratio(store, cid: str, names) -> float:
    """Stored bytes over logical bytes: each extent's compressed length,
    or a whole block."""
    from ceph_tpu_torch.objectstore.bluestore import BLOCK
    stored = logical = 0
    for name in names:
        meta = store._meta(cid, name)
        logical += meta["size"]
        co = meta.get("comp") or []
        for bi, b in enumerate(meta["extents"]):
            if b >= 0:
                c = co[bi] if bi < len(co) else None
                stored += c[1] if c else BLOCK
    return stored / logical


def _bs_counts(before: dict) -> dict:
    """BlueStoreStats moved since ``before``."""
    from ceph_tpu_torch.ops import telemetry
    now = telemetry.bluestore_dump()
    return {k: now[k] - before.get(k, 0) for k in now}


def _family_calls(name: str) -> int:
    from ceph_tpu_torch.ops import telemetry
    return telemetry.dump().get(name, {}).get("calls", 0)


def bluestore_phase(dev, tag: str, n_objects: int = BS_OBJECTS,
                    obj_bytes: int = BS_OBJ_BYTES,
                    cluster_objects: int = BS_CLUSTER_OBJECTS) -> tuple:
    """Phase 12: BlueStore on the card (see the docstring).  Returns the
    {"bluestore": ...} summary, the bitplane_pack kernels row, and
    scrub_digest's launches for the bluestore_data channel by sub-step
    (its telemetry family's calls: one launch each on the card)."""
    import shutil
    import tempfile
    import threading

    import torch

    from ceph_tpu_torch.common.context import CephTpuContext
    from ceph_tpu_torch.objectstore import Transaction
    from ceph_tpu_torch.objectstore.bluestore import BLOCK, BlueStoreLite
    from ceph_tpu_torch.ops import _build, telemetry
    from ceph_tpu_torch.tools.vstart import MiniCluster
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    telemetry.reset()
    root = tempfile.mkdtemp(prefix="chip_smoke_bluestore_")
    tap = _BlueStoreTap()
    steps: dict = {}
    pack_launches: dict = {}
    digest_launches: dict = {}
    sample_pack = None

    def step(label: str, body, total_mb: float, extra=None) -> dict:
        tap.reset()
        before = telemetry.bluestore_dump()
        fam = _family_calls("bluestore_data")
        telemetry.dispatch_stats().clear()
        telemetry.decode_dispatch_stats().clear()
        _build.reset_launches()
        t0 = time.perf_counter()
        body()
        if on_card:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        rec = {"seconds": secs, "MB_s": total_mb / secs,
               "bitplane_pack_launches": launches["bitplane_pack"],
               "scrub_digest_launches": launches["scrub_digest"],
               "gf_matvec_launches": launches["gf_matvec"],
               "bluestore_data_calls": _family_calls("bluestore_data") - fam,
               "bluestore_stats": _bs_counts(before),
               "engine_phases": {
                   side: {f: v for f, v in stats.phases.summary()[
                       "kernels"].items()}
                   for side, stats in (
                       ("encode", telemetry.dispatch_stats()),
                       ("decode", telemetry.decode_dispatch_stats()))}}
        if extra is not None:
            rec.update(extra())
        if on_card:
            rec["batches_checked"] = tap.check(label)
        steps[label] = rec
        pack_launches[label] = rec["bitplane_pack_launches"]
        digest_launches[label] = rec["bluestore_data_calls"]
        st = rec["bluestore_stats"]
        print(f"bluestore {label}: {total_mb:.1f} MB in {secs:.3f} s = "
              f"{rec['MB_s']:.1f} MB/s (host clock); launches bitplane_pack "
              f"{rec['bitplane_pack_launches']}, scrub_digest "
              f"{rec['scrub_digest_launches']} (bluestore_data calls "
              f"{rec['bluestore_data_calls']}), gf_matvec "
              f"{rec['gf_matvec_launches']}; csum blocks batched "
              f"{st['csum_blocks']} in {st['csum_batches']} batches, scalar "
              f"{st['csum_scalar_blocks']}; read-verify blocks "
              f"{st['read_verify_blocks']}; compressed "
              f"{st['compress_blocks']}, rejected {st['compress_rejected']}"
              f"  {tag}")
        for side, fams in rec["engine_phases"].items():
            for f, v in fams.items():
                print(f"bluestore {label}: {side} engines {f}: "
                      f"{v['batches']} batches, seconds "
                      + ", ".join(f"{ph} {x:.4f}" for ph, x in
                                  v["seconds"].items()) + f"  {tag}")
        return rec

    # -- 12a: one store on the card's context --------------------------------
    ctx = CephTpuContext("bluestore", device=dev)
    ctx.conf.set("bluestore_compression_mode", "aggressive", source="cli")
    ctx.conf.set("bluestore_compression_algorithm", "tpu_bitplane",
                 source="cli")
    ctx.conf.set("bluestore_compression_required_ratio", str(BS_RATIO),
                 source="cli")
    names = [f"bs_{i:04d}" for i in range(n_objects)]
    payload = bluestore_payloads(dev, names, obj_bytes, 12)
    total_mb = n_objects * obj_bytes / 1e6
    cid = "1.0"
    path = os.path.join(root, "store")
    store = BlueStoreLite(path, ctx=ctx)
    store.mkfs()
    store.mount()
    store.apply_transaction(Transaction().create_collection(cid))
    print(f"bluestore 12a: one BlueStoreLite on the card's context, "
          f"compression aggressive tpu_bitplane ratio {BS_RATIO}; "
          f"{n_objects} objects of {obj_bytes} B (thirds: 7-bit text, "
          f"small integers, random) in transactions of {BS_TXN_OBJECTS}  "
          f"{tag}")
    contexts = [ctx]
    c = client = None
    try:
        def write():
            for lo in range(0, n_objects, BS_TXN_OBJECTS):
                t = Transaction()
                for name in names[lo:lo + BS_TXN_OBJECTS]:
                    t.write(cid, name, 0, payload[name])
                store.apply_transaction(t)

        def read_back(st):
            def body():
                for name in names:
                    if st.read(cid, name) != payload[name]:
                        raise SmokeFailure(f"12a: {name} read back != the "
                                           f"bytes written")
            return body

        rec = step("12a_write", write, total_mb, lambda: {
            "stored_over_logical": _stored_ratio(store, cid, names)})
        if tap.packs:     # a small-integer object's batch, if there is one
            sample_pack = tap.packs[min(1, len(tap.packs) - 1)][0]
        print(f"bluestore 12a_write: stored bytes / logical bytes "
              f"{rec['stored_over_logical']:.4f}  {tag}")
        step("12a_read", read_back(store), total_mb)
        t0 = time.perf_counter()
        store.umount()
        store = BlueStoreLite(path, ctx=ctx)
        store.mount()
        mount_s = time.perf_counter() - t0
        rec = step("12a_remount_read", read_back(store), total_mb,
                   lambda: {"umount_mount_seconds": mount_s})
        print(f"bluestore 12a: umount + mount {mount_s:.3f} s  {tag}")
        # one bit of one stored block flipped in the block file
        victim = names[1]
        meta = store._meta(cid, victim)
        bi = len(meta["extents"]) // 2
        comp = (meta.get("comp") or [None] * (bi + 1))[bi]
        pos = meta["extents"][bi] * BLOCK + ((comp[1] if comp else BLOCK) // 2)
        with open(store._block_path, "r+b") as f:
            f.seek(pos)
            byte = f.read(1)
            f.seek(pos)
            f.write(bytes([byte[0] ^ 0x10]))
        before = telemetry.bluestore_dump()
        try:
            store.read(cid, victim)
            raised = False
        except IOError:
            raised = True
        errs = _bs_counts(before)["csum_errors"]
        steps["12a_bit_flip"] = {"object": victim, "block": bi,
                                 "compressed": comp is not None,
                                 "raised_ioerror": raised,
                                 "csum_errors": errs}
        check(raised and errs == 1,
              f"12a: one bit flipped in block {bi} of {victim} "
              f"({'compressed' if comp else 'raw'}): the read raises IOError, "
              f"csum_errors {errs}")
        summary_a = telemetry.bluestore_summary()
        print(f"bluestore 12a: BlueStoreStats.summary() {summary_a}  {tag}")
        check(summary_a["scalar_csum_blocks"] == 0
              and summary_a["csum_fallbacks"] == 0,
              f"12a: no scalar csum block, no fallback batch "
              f"({summary_a['scalar_csum_blocks']}, "
              f"{summary_a['csum_fallbacks']})")
        check(not on_card or (steps["12a_write"]["bitplane_pack_launches"] > 0
                              and all(steps[k]["scrub_digest_launches"] > 0
                                      for k in ("12a_write", "12a_read",
                                                "12a_remount_read"))),
              "12a: bitplane_pack launched by the writes, scrub_digest by "
              "the writes and both reads")
        assert_no_faults("12a", ctx.fault_digest())
        store.umount()
        store = None

        # -- 12b: a MiniCluster on BlueStore -----------------------------------
        telemetry.bluestore_stats().clear()
        cnames = [f"bsc_{i:04d}" for i in range(cluster_objects)]
        cpayload = bluestore_payloads(dev, cnames, obj_bytes, 13)
        cmb = cluster_objects * obj_bytes / 1e6
        t0 = time.perf_counter()
        c = MiniCluster(n_osds=BS_CLUSTER_OSDS, ms_type="loopback",
                        store_type="bluestore",
                        base_path=os.path.join(root, "cluster"),
                        device=dev).start()
        c.wait_for_osd_count(BS_CLUSTER_OSDS, timeout=CLUSTER_OP_TIMEOUT)
        client = c.client(timeout=CLUSTER_OP_TIMEOUT)
        contexts += [c.mon.ctx, client.ctx] + [o.ctx
                                               for o in c.osds.values()]
        start_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pool = c.create_pool(client, pool_type="erasure", plugin="jerasure",
                             technique="reed_sol_van", k=BS_K, m=BS_M,
                             pg_num=BS_PG_NUM,
                             epoch_timeout=CLUSTER_OP_TIMEOUT)
        create_s = time.perf_counter() - t0
        peer_s = _wait_active(c, pool, BS_PG_NUM, CLUSTER_OP_TIMEOUT)
        t0 = time.perf_counter()
        for var, val in (("compression_mode", "aggressive"),
                         ("compression_algorithm", "tpu_bitplane")):
            rc, out = client.mon_command({"prefix": "osd pool set",
                                          "pool": str(pool), "var": var,
                                          "val": val})
            check(rc == 0, f"12b: osd pool set {var} {val}: {out}")
        c.wait_for_epoch(c.mon.osdmap.epoch, timeout=CLUSTER_OP_TIMEOUT)
        client.wait_for_epoch(c.mon.osdmap.epoch)
        set_s = time.perf_counter() - t0
        print(f"bluestore 12b: {BS_CLUSTER_OSDS} OSDs on bluestore "
              f"(loopback, 1 mon) up in {start_s:.1f} s; pool {pool} "
              f"jerasure reed_sol_van k={BS_K} m={BS_M} pg_num {BS_PG_NUM} "
              f"created (its first map epoch) in {create_s:.1f} s, every PG "
              f"active {peer_s:.1f} s later; compression aggressive "
              f"tpu_bitplane set in {set_s:.1f} s; {cluster_objects} objects "
              f"of {obj_bytes} B, {CLUSTER_IN_FLIGHT} in flight  {tag}")
        io = client.open_ioctx(pool)

        def check_read(name, comp_):
            if comp_.reply.ops[0].data != cpayload[name]:
                raise SmokeFailure(f"12b: {name} read back != the bytes "
                                   f"written")

        def read_all():
            _rados_bench(cnames, io.aio_read, check_read)

        step("12b_write", lambda: _rados_bench(
            cnames, lambda n: io.aio_write_full(n, cpayload[n]),
            lambda n, comp_: None), cmb)
        step("12b_read", read_all, cmb)
        c.kill_osd(BS_VICTIM)
        rc, out = client.mon_command({"prefix": "osd down",
                                      "id": str(BS_VICTIM)})
        check(rc == 0, f"osd down {BS_VICTIM}: {out}")
        c.wait_for_epoch(c.mon.osdmap.epoch, timeout=CLUSTER_OP_TIMEOUT)
        client.wait_for_epoch(c.mon.osdmap.epoch)
        rec = step("12b_degraded_read", read_all, cmb)
        if on_card:     # the same reads again, under torch.profiler
            busy = _busy(read_all, lambda: None)
            rec.update(busy_share=busy["busy_share"],
                       busy_window_ms=busy["window_ms"])
            print(f"bluestore 12b_degraded_read: card busy share "
                  + (f"{rec['busy_share']:.4f}" if rec["busy_share"]
                     is not None else "not measured")
                  + f" (window {rec['busy_window_ms']:.1f} ms)  {tag}")
        check(not on_card or rec["gf_matvec_launches"] >= 1,
              f"12b: degraded reads decode through gf_matvec "
              f"({rec['gf_matvec_launches']} launches)")

        def restart():
            c.run_osd(BS_VICTIM)
            c.wait_for_osd_count(BS_CLUSTER_OSDS, timeout=CLUSTER_OP_TIMEOUT)
            c.wait_for_epoch(c.mon.osdmap.epoch, timeout=CLUSTER_OP_TIMEOUT)
            deadline = time.time() + CLUSTER_RECOVERY_S
            while True:
                bad, _holes = _shard_placement(c, pool, cnames, deep=False)
                if not bad:
                    bad, _holes = _shard_placement(c, pool, cnames,
                                                   deep=True)
                    if not bad:
                        return
                if time.time() > deadline:
                    raise SmokeFailure(
                        f"12b: {len(bad)} shards not on their mapped OSDs "
                        f"with a matching hinfo after {CLUSTER_RECOVERY_S} "
                        f"s, e.g. {bad[:4]}")
                time.sleep(0.25)
        step("12b_restart", restart, cmb)
        contexts.append(c.osds[BS_VICTIM].ctx)
        check(isinstance(c.osds[BS_VICTIM].store, BlueStoreLite),
              f"12b: osd.{BS_VICTIM} restarted on its own path: its store "
              f"remounted, every object's {BS_K + BS_M} shards on their "
              f"OSDs with matching hinfo")
        osds = list(c.osds.values())
        aggs = [None] * len(osds)

        def scrub():
            def one(i):
                aggs[i] = osds[i].scrub_all_pgs()
            th = [threading.Thread(target=one, args=(i,))
                  for i in range(len(osds))]
            for t in th:
                t.start()
            for t in th:
                t.join()
        rec = step("12b_scrub", scrub, cmb, lambda: {
            "pgs": sum(a["pgs"] for a in aggs),
            "clean": all(a["clean"] for a in aggs),
            "inconsistent": sorted(o for a in aggs
                                   for o in a["inconsistent"]),
            "errors": [e for a in aggs for e in a.get("errors", ())]})
        check(rec["clean"] and not rec["inconsistent"] and not rec["errors"]
              and rec["pgs"] == BS_PG_NUM,
              f"12b: one scrub_all_pgs pass over all {BS_PG_NUM} PGs is "
              f"clean ({rec['inconsistent']}, {rec['errors'][:2]})")
        summary_b = telemetry.bluestore_summary()
        print(f"bluestore 12b: BlueStoreStats.summary() {summary_b} "
              f"(commits on an engine's own thread take the scalar crc by "
              f"design)  {tag}")
        check(summary_b["csum_batches"] > 0,
              f"12b: the OSDs' commits went through the bluestore_data "
              f"channel ({summary_b['csum_batches']} batches, "
              f"{summary_b['batched_csum_blocks']} blocks; scalar "
              f"{summary_b['scalar_csum_blocks']})")
        for ctx_ in contexts[1:]:
            assert_no_faults(f"12: {ctx_.name}", ctx_.fault_digest())
    finally:
        tap.close()
        if store is not None:
            store.umount()
        if c is not None:
            c.stop()
        for ctx_ in contexts:
            ctx_.stop()
        shutil.rmtree(root, ignore_errors=True)
    ctx_names = {ctx_.name for ctx_ in contexts}
    c = client = contexts = ctx = None
    gc.collect()
    deadline = time.time() + 10
    alive = []
    while time.time() < deadline:
        alive = [t.name for t in threading.enumerate() if t.is_alive()
                 and t.name.split("-")[0] in ctx_names]
        if not alive:
            break
        time.sleep(0.05)
    check(not alive, f"12: no engine thread alive after stop() "
          f"({alive[:4]})")
    secs = time.perf_counter() - t_phase
    print(f"bluestore: phase 12 took {secs:.1f} s (budget "
          f"{BS_BUDGET_S:.0f} s)  {tag}")
    row = bitplane_row(dev, tag, sample_pack, pack_launches,
                       getattr(tap, "err", 0)) if on_card else None
    summary = {"store": {"objects": n_objects, "object_bytes": obj_bytes,
                         "txn_objects": BS_TXN_OBJECTS,
                         "compression": ["aggressive", "tpu_bitplane",
                                         BS_RATIO],
                         "summary": summary_a},
               "cluster": {"osds": BS_CLUSTER_OSDS, "k": BS_K, "m": BS_M,
                           "pg_num": BS_PG_NUM, "objects": cluster_objects,
                           "start_seconds": start_s,
                           "pool_create_seconds": create_s,
                           "peering_seconds": peer_s,
                           "summary": summary_b},
               "steps": steps, "phase_seconds": secs}
    return summary, row, digest_launches


def pack_operands(dev, s: int, w: int, rot: int, offset: int = 0,
                  seed: int = 14) -> tuple[list, list]:
    """``rot`` (s, w) uint8 inputs of random bytes on ``dev``, each starting
    ``offset`` bytes into its own allocation, and ``rot`` (s, 8, w / 8)
    outputs."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randint(0, 256, (s * w + offset,), dtype=torch.uint8,
                        device=dev, generator=gen)[offset:].view(s, w)
          for _ in range(rot)]
    outs = [torch.empty((s, 8, w // 8), dtype=torch.uint8, device=dev)
            for _ in range(rot)]
    return xs, outs


def pack_rot(s: int, w: int) -> int:
    """Inputs a cold pack turns over: PACK_COLD_BYTES of inputs and
    outputs."""
    return max(1, PACK_COLD_BYTES // (2 * s * w))


def bitplane_row(dev, tag: str, sample, launches: dict, err: int) -> dict:
    """bitplane_pack alone at PACK_SHAPES on random bytes, each input held
    against the plain version on the card (exact): timed by graph replay
    (also behind a queued spin kernel, ``queued_graph_times``) beside the
    launches issued from Python, cold (launches turn over pack_rot inputs
    and outputs, 64 MiB, past the 50 MB L2, as the bound assumes) and warm (one input, in L2), beside its bound (each input byte
    read once, each plane byte written once) and the plain version's time;
    warm at one of 12a's batches; a ragged call on an unaligned pointer
    (PACK_RAGGED) held against the plain version; the kernel's registers,
    spills and SASS calls (none a 64-bit divide)."""
    import torch

    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import compression_kernel as bk
    from ceph_tpu_torch.tools import sass_report

    def launch(x, out):
        _build.launch("bitplane_pack", "bitplane_pack_launch", x.data_ptr(),
                      out.data_ptr(), x.shape[0], x.shape[1])

    def max_err(x, out):
        return int((out.long() - bk.bitplane_planes_plain(x).long()).abs()
                   .max())

    try:
        sass = {name: r for name, r in
                sass_report.report(_build.build()).items()
                if name.startswith("bitplane_pack_kernel")}
    except (OSError, subprocess.CalledProcessError) as e:
        sass = {}
        print(f"bitplane_pack SASS and registers: not measured ({e})")
    if sass:
        print(sass_report.format_report(sass))
        for name, r in sass.items():
            check("u64 divide" not in r["calls"] and r.get("local") == 0,
                  f"{name}: no 64-bit divide, no spills "
                  f"({r.get('registers')} registers, calls: "
                  f"{r['calls'] or 'none'})")
    s, w, offset = PACK_RAGGED
    (x,), (out,) = pack_operands(dev, s, w, 1, offset, seed=15)
    launch(x, out)
    e = max_err(x, out)
    err = max(err, e)
    check(e == 0 and x.data_ptr() % 16 == offset,
          f"bitplane_pack == plain torch at ragged ({s}, {w}) on a data "
          f"pointer {offset} byte(s) off 16-byte alignment")
    row = {"name": "bitplane_pack", "route": "cuda",
           "source": "ceph_tpu_torch/csrc/bitplane.cu",
           "replaces": "ceph_tpu/ops/compression_kernel.py:61",
           "launches": sum(launches.values()),
           "launches_by_sub_step": launches, "library_ms": None,
           "ragged": [s, w, offset], "ragged_max_abs_err": e,
           "registers": {n: r.get("registers") for n, r in sass.items()},
           "by_shape": []}
    for s, w in PACK_SHAPES:
        rot = pack_rot(s, w)
        xs, outs = pack_operands(dev, s, w, rot)
        for x, out in zip(xs, outs):
            launch(x, out)
            err = max(err, max_err(x, out))
        check(err == 0, f"bitplane_pack == plain torch on {rot} random "
              f"{(s, w)} inputs and every phase-12 batch")
        turn = {"i": 0}

        def cold(xs=xs, outs=outs, rot=rot):
            i = turn["i"] % rot
            turn["i"] += 1
            launch(xs[i], outs[i])

        b_ms, b_by = bound(2 * s * w, 0)
        g, h = paired_times(cold, 2 * rot)
        shape = {"S": s, "W": w, "inputs": rot, "ms": statistics.median(g),
                 "host_ms": statistics.median(h), "bound_ms": b_ms,
                 "bound_by": b_by}
        shape["queued_ms"] = statistics.median(
            queued_graph_times(cold, 2 * rot))
        g, h = paired_times(lambda: launch(xs[0], outs[0]), 16)
        shape.update(warm_ms=statistics.median(g),
                     warm_host_ms=statistics.median(h),
                     warm_queued_ms=statistics.median(queued_graph_times(
                         lambda: launch(xs[0], outs[0]), 16)))
        shape["share"] = b_ms / shape["ms"]
        shape["GB_s"] = 2 * s * w / shape["ms"] / 1e6
        if not row["by_shape"]:     # BlueStore's 4 MiB write heads the row
            row.update(max_abs_err=err, matches_plain=err == 0, bound_ms=b_ms,
                       bound_by=b_by, shape=f"{(s, w)} random, cold",
                       ms=shape["ms"], host_ms=shape["host_ms"],
                       queued_ms=shape["queued_ms"], warm_ms=shape["warm_ms"],
                       warm_host_ms=shape["warm_host_ms"], GB_s=shape["GB_s"])
            row["plain_ms"] = time_ms(
                lambda: bk.bitplane_planes_plain(xs[0]), 1, reps=5)
        row["by_shape"].append(shape)
        print(f"bitplane_pack   {(s, w)} random: kernel {shape['ms']:.4f} ms "
              f"cold (graph replay over {rot} inputs; "
              f"{shape['queued_ms']:.4f} queued behind a spin kernel; "
              f"{shape['host_ms']:.4f} issued) = {shape['GB_s']:.1f} GB/s "
              f"moved, {shape['share']:.0%} of its bound, "
              f"{shape['warm_ms']:.4f} ms warm ({shape['warm_queued_ms']:.4f} "
              f"queued; {shape['warm_host_ms']:.4f} issued)  bound "
              f"{b_ms:.4f} ms ({b_by})  {tag}")
        check(shape["ms"] >= b_ms, f"bitplane_pack {(s, w)} cold: graph "
              f"replay {shape['ms']:.4f} ms at or above its bound "
              f"{b_ms:.4f} ms")
        del xs, outs
    row["max_abs_err"] = err
    row["matches_plain"] = err == 0
    print(f"bitplane_pack   plain {row['plain_ms']:.3f} ms at "
          f"{PACK_SHAPES[0]}  {tag}")
    if sample is not None:
        out_s = torch.empty((sample.shape[0], 8, sample.shape[1] // 8),
                            dtype=torch.uint8, device=dev)
        g, h = paired_times(lambda: launch(sample, out_s), 16)
        row.update(sample_shape=list(sample.shape),
                   sample_ms=statistics.median(g),
                   sample_host_ms=statistics.median(h))
        print(f"bitplane_pack   a 12a batch {tuple(sample.shape)}: kernel "
              f"{row['sample_ms']:.4f} ms warm (graph replay; "
              f"{row['sample_host_ms']:.4f} issued)  {tag}")
    return row


def words_row(dev, m, launches: list) -> dict:
    """pg_osd_words at the map's OSD count: held against osd_words_plain,
    timed by graph replay, beside its bound (each OSD's three entries read,
    its word written)."""
    import torch

    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import placement_cuda as pc
    vec = [torch.from_numpy(v).to(dev) for v in m.dense_osd_vectors()]
    words = pc.osd_words(*vec)
    plain_ = pc.osd_words_plain(*vec)
    err = int((words.long() - plain_.long()).abs().max())
    out = torch.empty_like(words)
    m_osd = vec[0].shape[0]

    def launch():
        _build.launch("pg_osd_words", "pg_osd_words_launch",
                      vec[0].data_ptr(), vec[1].data_ptr(), vec[2].data_ptr(),
                      m_osd, out.data_ptr())

    g, h = paired_times(launch, 20)
    b_ms, b_by = bound(sum(v.nbytes for v in vec) + out.nbytes, 0)
    row = {"name": "pg_osd_words", "route": "cuda",
           "source": "ceph_tpu_torch/csrc/placement.cu",
           "replaces": "ceph_tpu/ops/placement_kernel.py:84",
           "launches": sum(launches), "launches_per_epoch": launches,
           "max_abs_err": err, "matches_plain": err == 0,
           "ms": statistics.median(g), "host_ms": statistics.median(h),
           "plain_ms": time_ms(lambda: pc.osd_words_plain(*vec), 1, reps=5),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "shape": f"M={m_osd}"}
    check(err == 0 and torch.equal(out, words),
          f"pg_osd_words == osd_words_plain on {m_osd} OSDs")
    check(row["ms"] >= b_ms, f"pg_osd_words: graph replay {row['ms']:.4f} "
          f"ms at or above its bound {b_ms:.4f} ms")
    print(f"pg_osd_words M={m_osd} {row['ms']:.4f} ms (graph replay; "
          f"{row['host_ms']:.4f} issued)  plain {row['plain_ms']:.4f} ms  "
          f"bound {b_ms:.5f} ms ({b_by})  launches per epoch {launches}")
    return row


class _WhatIfTap:
    """Wraps SharedPGMappingService.what_if_up (every service of the
    process: the mgr's in 13a, phase 9's in 13b) and the engine's
    submit_finish_ladder: each what-if batch is recorded with its
    candidates, seconds, pg_finish_ladder launches, whether the fused
    ladder scored it, and the operands and future of each ladder it
    submitted, to be held against ladder_plain afterwards."""

    def __init__(self):
        import threading

        from ceph_tpu_torch.ops import dispatch
        from ceph_tpu_torch.osd.mapping import SharedPGMappingService
        self._lock = threading.Lock()
        self._local = threading.local()
        self.batches: list[dict] = []
        self._dispatch, self._cls = dispatch, SharedPGMappingService
        self._real_submit = dispatch.submit_finish_ladder
        self._real_what_if = SharedPGMappingService.what_if_up
        tap = self

        def submit(engine, operands, **kw):
            fut = tap._real_submit(engine, operands, **kw)
            rec = getattr(tap._local, "rec", None)
            if rec is not None:
                rec["ladders"].append((operands, fut))
            return fut

        def what_if_up(svc, osdmap, pool_id, candidates):
            from ceph_tpu_torch.ops import _build
            rec = {"pool": pool_id, "candidates": len(candidates),
                   "ladders": []}
            tap._local.rec = rec
            l0 = _build.LAUNCHES["pg_finish_ladder"]
            t0 = time.perf_counter()
            try:
                got = tap._real_what_if(svc, osdmap, pool_id, candidates)
            finally:
                tap._local.rec = None
            rec["seconds"] = time.perf_counter() - t0
            rec["launches"] = _build.LAUNCHES["pg_finish_ladder"] - l0
            rec["scored"] = got is not None
            with tap._lock:
                tap.batches.append(rec)
            return got

        dispatch.submit_finish_ladder = submit
        SharedPGMappingService.what_if_up = what_if_up

    def close(self) -> None:
        self._dispatch.submit_finish_ladder = self._real_submit
        self._cls.what_if_up = self._real_what_if

    def since(self, n: int) -> list[dict]:
        with self._lock:
            return list(self.batches[n:])

    @staticmethod
    def hold(recs, dev) -> tuple[int, int]:
        """Each recorded ladder's packed rows == ladder_plain on ``dev`` on
        the same operands: (ladders held, max abs err)."""
        import numpy as np
        import torch

        from ceph_tpu_torch.ops import placement_kernel as pk
        n, err = 0, 0
        for rec in recs:
            for op, fut in rec["ladders"]:
                got = torch.from_numpy(np.asarray(fut.result(timeout=60)))
                want = pk.ladder_plain(*on_card(op, dev),
                                       erasure=op.erasure).cpu()
                err = max(err, int((got.long() - want.long()).abs().max()))
                n += 1
        return n, err


def parse_metrics(text: str) -> dict:
    """Prometheus text exposition, strictly: {family: {"type", "help",
    "samples": [(name, labels, value)]}}; a malformed line, or a sample
    without its family's HELP and TYPE before it, raises."""
    import re
    sample_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    declared: dict = {}
    fams: dict = {}
    for line in text.splitlines():
        if not line:
            continue
        for key, head in (("help", "# HELP "), ("type", "# TYPE ")):
            if line.startswith(head):
                name, _, val = line[len(head):].partition(" ")
                declared.setdefault(name, {})[key] = val
                break
        else:
            m = sample_re.match(line)
            if m is None or line.startswith("#"):
                raise SmokeFailure(f"malformed exposition line {line!r}")
            name = fam = m.group(1)
            for suffix in ("_bucket", "_sum", "_count"):
                base = name[:-len(suffix)]
                if name.endswith(suffix) and declared.get(base, {}).get(
                        "type") in ("histogram", "summary"):
                    fam = base
                    break
            if set(declared.get(fam, {})) != {"help", "type"}:
                raise SmokeFailure(f"sample {name} without HELP and TYPE")
            fams.setdefault(fam, {**declared[fam], "samples": []})[
                "samples"].append((name, dict(label_re.findall(
                    m.group(2) or "")),
                    float(m.group(3).replace("+Inf", "inf"))))
    return fams


def _spreads(bal, m, pools, **svc) -> dict:
    return {pid: bal.spread(m, pid, **svc) for pid in pools}


def mgr_cluster(dev, tag: str, steps: dict) -> dict:
    """Phase 13a (see the module docstring): the manager on a MiniCluster
    on the card.  Fills ``steps`` with each sub-step's seconds and launches;
    returns the sub-phase's summary."""
    import threading
    import urllib.request

    import torch

    from ceph_tpu_torch import balancer as bal
    from ceph_tpu_torch.client.rados import ceph_str_hash_rjenkins
    from ceph_tpu_torch.ops import _build, telemetry
    from ceph_tpu_torch.osd.osdmap import CEPH_NOSD, pg_to_pgid
    from ceph_tpu_torch.osd.pg import STATE_ACTIVE
    from ceph_tpu_torch.tools.vstart import MiniCluster
    on_card = dev.type == "cuda"
    names = {pid: [f"mgr_{pid}_{i:03d}" for i in range(MGR_OBJECTS)]
             for pid in (1, 2)}
    gen_ = torch.Generator(device=dev).manual_seed(13)
    payload = {}
    for pid in (1, 2):
        block = torch.randint(0, 256, (MGR_OBJECTS, MGR_OBJ_BYTES),
                              dtype=torch.uint8, device=dev,
                              generator=gen_).cpu().numpy()
        payload.update({n: row.tobytes() for n, row in zip(names[pid],
                                                            block)})
    mb = 2 * MGR_OBJECTS * MGR_OBJ_BYTES / 1e6
    tap = _WhatIfTap()
    c = MiniCluster(n_osds=0, ms_type="loopback", store_type="memstore",
                    device=dev).start()
    contexts = [c.mon.ctx]
    out: dict = {"osds": MGR_OSDS}

    def sub(label, body):
        _build.reset_launches()
        t0 = time.perf_counter()
        extra = body() or {}
        if on_card:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        steps[label] = {"seconds": secs, "launches": launches,
                        **{k: v for k, v in extra.items()
                           if not k.startswith("_")}}
        print(f"13a {label}: {secs:.2f} s; launches {launches}; "
              f"{json.dumps(steps[label])[:800]}  {tag}")
        return {**steps[label], **extra}

    try:
        mgrs = [c.run_mgr(0), c.run_mgr(1)]
        for mgr in mgrs:
            mgr.ctx.conf.set("osdmap_mapping_min_pgs", MGR_MIN_PGS)
        contexts += [mgr.ctx for mgr in mgrs]
        for i in range(MGR_OSDS):
            c.run_osd(i)
        c.wait_for_osd_count(MGR_OSDS, timeout=CLUSTER_OP_TIMEOUT)
        client = c.client(timeout=CLUSTER_OP_TIMEOUT)
        contexts += [client.ctx] + [o.ctx for o in c.osds.values()]
        deadline = time.time() + CLUSTER_OP_TIMEOUT
        while (client.osdmap.mgr_db or {}).get("active_name") != "mgr.0" \
                or not mgrs[0].is_active:
            if time.time() > deadline:
                raise SmokeFailure(f"13a: mgr.0 never named active "
                                   f"({client.osdmap.mgr_db})")
            time.sleep(0.05)
        t0 = time.perf_counter()
        rep = c.create_pool(client, pg_num=MGR_REP_PGS, size=3,
                            epoch_timeout=CLUSTER_OP_TIMEOUT)
        ec = c.create_pool(client, pool_type="erasure", plugin="jerasure",
                           technique="reed_sol_van", k=MGR_K, m=MGR_M,
                           pg_num=MGR_EC_PGS,
                           epoch_timeout=CLUSTER_OP_TIMEOUT)
        pools = {rep: MGR_REP_PGS, ec: MGR_EC_PGS}
        for pid, pg_num in pools.items():
            _wait_active(c, pid, pg_num, CLUSTER_OP_TIMEOUT)
        check(sorted(pools) == [1, 2], f"13a: pools {sorted(pools)}")
        out["pools_seconds"] = time.perf_counter() - t0
        print(f"13a: {MGR_OSDS} OSDs (memstore, loopback, 1 mon), mgr.0 "
              f"active and mgr.1 standby (started first, "
              f"osdmap_mapping_min_pgs {MGR_MIN_PGS} on their contexts); "
              f"pool 1 replicated size 3 pg_num {MGR_REP_PGS}, pool 2 "
              f"jerasure reed_sol_van k={MGR_K} m={MGR_M} pg_num "
              f"{MGR_EC_PGS}: created and every PG active in "
              f"{out['pools_seconds']:.1f} s  {tag}")
        ios = {pid: client.open_ioctx(pid) for pid in pools}
        telemetry.reset()

        # 1. rados bench's writes, iostat polled while they run
        seen_wr = []
        stop = threading.Event()

        def watch():
            # polled while the writes run and until a report window that
            # holds them has landed (OSDs report every 0.5 s)
            deadline = None
            while not (stop.is_set() and (max(seen_wr, default=0) > 0
                                          or time.time() > deadline)):
                if stop.is_set() and deadline is None:
                    deadline = time.time() + 10.0
                rc, txt = client.mgr_command({"prefix": "iostat"})
                if rc == 0:
                    seen_wr.append(json.loads(txt)["total_wr_ops_s"])
                time.sleep(0.25)

        def write():
            th = threading.Thread(target=watch, daemon=True)
            th.start()
            try:
                secs = 0.0
                for pid in pools:
                    secs += _rados_bench(
                        names[pid], lambda n, io=ios[pid]:
                        io.aio_write_full(n, payload[n]),
                        lambda n, comp_: None)
            finally:
                stop.set()
                th.join(timeout=30)
            return {"MB_s": mb / secs,
                    "iostat_max_wr_ops_s": max(seen_wr, default=0.0)}
        rec = sub("1_write", write)
        writes_gf = rec["launches"].get("gf_matvec", 0)
        check(rec["iostat_max_wr_ops_s"] > 0,
              f"13a: iostat through mgr_command showed write operations "
              f"while the writes ran (max {rec['iostat_max_wr_ops_s']} "
              f"ops/s over {len(seen_wr)} polls)")
        check(not on_card or writes_gf >= 1,
              f"13a: the EC writes encoded through gf_matvec ({writes_gf})")

        # 2. iostat, pg dump and df through the mgr's command tier, once
        # the reports that follow the writes have landed: every replica and
        # every shard the map places (chooseleaf indep on a pool as wide as
        # the OSDs can leave a position without one)
        m = c.mon.osdmap
        want_objs = sum(
            sum(1 for o in m.pg_to_up_acting_osds(pid, pg_to_pgid(
                ceph_str_hash_rjenkins(n), m.pools[pid].pg_num))[0]
                if o != CEPH_NOSD)
            for pid in pools for n in names[pid])

        def views():
            want_rows = sum(pools.values())
            deadline = time.time() + CLUSTER_OP_TIMEOUT
            while True:
                rc, txt = client.mgr_command({"prefix": "pg dump"})
                rows = json.loads(txt)["pg_stats"] if rc == 0 else []
                rc_d, df_txt = client.mgr_command({"prefix": "df"})
                df = json.loads(df_txt) if rc_d == 0 else {}
                if (len(rows) == want_rows
                        and all(r["state"] == "active" for r in rows)
                        and sum(r["num_objects"] for r in rows)
                        == 2 * MGR_OBJECTS
                        and df.get("total_objects") == want_objs):
                    break
                if time.time() > deadline:
                    raise SmokeFailure(
                        f"13a: the reports never settled: {len(rows)} pg "
                        f"dump rows, df {df.get('total_objects')} of "
                        f"{want_objs} replicas and shards")
                time.sleep(0.1)
            rc_i, io_txt = client.mgr_command({"prefix": "iostat"})
            check(rc_i == 0, "13a: iostat answers")
            return {"pg_rows": len(rows), "df": df,
                    "iostat": json.loads(io_txt), "_rows": rows}
        rec = sub("2_views", views)
        rows = rec.pop("_rows")
        bad = []
        for row in rows:
            pgid = tuple(int(x) for x in row["pgid"].split("."))
            pg = c.osds[row["reported_by"]].pgs.get(pgid)
            if (pg is None or pg.state != STATE_ACTIVE
                    or row["up"] != list(pg.up)
                    or tuple(row["log_head"]) != tuple(pg.log.head)
                    or row["log_size"] != len(pg.log.entries)):
                bad.append(row["pgid"])
        check(not bad, f"13a: pg dump's {len(rows)} rows equal each "
              f"primary OSD's own PG (state, up, log head and size) {bad[:4]}")
        check(rec["df"]["total_objects"] == want_objs,
              f"13a: df counts every object written: "
              f"{rec['df']['total_objects']} stored == {want_objs} replicas "
              f"and shards the map places ({MGR_OBJECTS} x 3 + "
              f"{MGR_OBJECTS} x {MGR_K + MGR_M} less the map's holes)")

        # 3. the Prometheus scrape over HTTP
        def scrape():
            port = mgrs[0].serve_prometheus(0)
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30).read()
            fams = parse_metrics(body.decode())
            val = {lab.get("kernel"): v for _n, lab, v in
                   fams["ceph_kernel_launches_total"]["samples"]}
            calls = sum(fams[f"ceph_kernel_{k}_calls_total"]["samples"][0][2]
                        for k in ("ec_encode", "ec_decode"))
            return {"bytes": len(body), "families": len(fams),
                    "gf_matvec_launches": val["gf_matvec"],
                    "ec_calls": calls}
        rec = sub("3_scrape", scrape)
        check(rec["gf_matvec_launches"] == _build.LAUNCHES["gf_matvec"]
              and (rec["ec_calls"] == writes_gf or not on_card),
              f"13a: the scrape parses ({rec['families']} families); its "
              f"gf_matvec launches {rec['gf_matvec_launches']} equal the "
              f"count since the sub-step's reset, and the EC engines' "
              f"ec_encode + ec_decode calls {rec['ec_calls']} equal the "
              f"writes' gf_matvec launches {writes_gf}")

        # 4. balancer optimize through the mgr; the plan to the mon.  The
        # map the module planned on is recorded, for its fused-off twin
        planned_on = []
        real_plan = bal.plan_commands

        def plan_commands(osdmap, **kw):
            planned_on.append(osdmap)
            return real_plan(osdmap, **kw)

        n0 = len(tap.batches)

        def optimize():
            bal.plan_commands = plan_commands
            try:
                rc, txt = client.mgr_command(
                    {"prefix": "balancer optimize"})
            finally:
                bal.plan_commands = real_plan
            check(rc == 0, f"13a: balancer optimize: rc {rc} {txt[:200]}")
            return {"commands": json.loads(txt)["commands"]}
        rec = sub("4_balancer", optimize)
        cmds = rec["commands"]
        check(len(planned_on) == 1, "13a: the module planned once")
        m_plan = planned_on[0]
        spread0 = _spreads(bal, m_plan, pools, ctx=mgrs[0].ctx)
        recs = tap.since(n0)
        wi_launches = sum(r["launches"] for r in recs)
        held, err = tap.hold(recs, dev)
        check(all(r["scored"] for r in recs) and held >= len(recs) >= 1
              and (wi_launches >= 1 or not on_card),
              f"13a: {len(recs)} what_if_up batches "
              f"({[r['candidates'] for r in recs]} candidates), each "
              f"scored by the fused ladder: pg_finish_ladder launched "
              f"{wi_launches} times for the what-if")
        check(err == 0, f"13a: every what_if_up batch ({held} ladders) == "
              f"ladder_plain on the card on the same operands")
        mgrs[0].ctx.conf.set("osdmap_mapping_fused", False)
        try:
            n1 = len(tap.batches)
            twin = bal.plan_commands(m_plan, ctx=mgrs[0].ctx)
            off = tap.since(n1)
        finally:
            mgrs[0].ctx.conf.set("osdmap_mapping_fused", True)
        check(twin == cmds and not any(r["scored"] for r in off),
              f"13a: the plan ({len(cmds)} commands) equals the plan with "
              f"osdmap_mapping_fused off on the mgr's context, command for "
              f"command (every score of {len(off)} batches from the host)")
        epoch0 = c.mon.osdmap.epoch

        def upmap():
            for cmd in cmds:
                rc, txt = client.mon_command(cmd)
                if rc != 0:
                    raise SmokeFailure(f"13a: {cmd}: rc {rc} {txt}")
            c.wait_for_epoch(c.mon.osdmap.epoch, timeout=CLUSTER_OP_TIMEOUT)
            for pid, pg_num in pools.items():
                _wait_active(c, pid, pg_num, CLUSTER_OP_TIMEOUT)
            deadline = time.time() + CLUSTER_OP_TIMEOUT
            while mgrs[0].osdmap.epoch < c.mon.osdmap.epoch:
                if time.time() > deadline:
                    raise SmokeFailure("13a: the mgr never saw the upmap "
                                       "epoch")
                time.sleep(0.05)
            return {"epochs": c.mon.osdmap.epoch - epoch0}
        rec = sub("4_upmap_epoch", upmap)
        spread1 = _spreads(bal, mgrs[0].osdmap, pools, ctx=mgrs[0].ctx)
        check(not cmds or rec["epochs"] >= 1,
              f"13a: the mon made {rec['epochs']} new epoch(s) of the plan")
        check(all(spread1[p][1] - spread1[p][0] <= spread0[p][1]
                  - spread0[p][0] for p in pools),
              f"13a: neither pool's (min, max) PGs an OSD is wider after "
              f"the upmap epoch: {spread0} -> {spread1}")
        out.update(balancer_commands=len(cmds), what_if_batches=len(recs),
                   what_if_candidates=[r["candidates"] for r in recs],
                   what_if_launches=wi_launches,
                   spread_before=spread0, spread_after=spread1)

        # 5. osd reweight-by-utilization on the mon
        def reweight():
            rc, txt = client.mon_command(
                {"prefix": "osd reweight-by-utilization"})
            check(rc == 0, f"13a: osd reweight-by-utilization: {txt}")
            plan = json.loads(txt)["reweighted"]
            if plan:
                c.wait_for_epoch(c.mon.osdmap.epoch,
                                 timeout=CLUSTER_OP_TIMEOUT)
                for pid, pg_num in pools.items():
                    _wait_active(c, pid, pg_num, CLUSTER_OP_TIMEOUT)
            return {"reweighted": plan}
        rec = sub("5_reweight", reweight)
        out["reweighted"] = rec["reweighted"]

        # 6. mgr.0 killed: mgr.1 promoted, still answering pg dump
        def failover():
            c.kill_mgr(0)
            deadline = time.time() + CLUSTER_OP_TIMEOUT
            # the client re-targets once its map names the new active
            while ((client.osdmap.mgr_db or {}).get("active_name")
                   != "mgr.1" or not mgrs[1].is_active):
                if time.time() > deadline:
                    raise SmokeFailure(f"13a: mgr.1 never promoted "
                                       f"({client.osdmap.mgr_db})")
                time.sleep(0.05)
            promoted = time.perf_counter()
            while True:
                rc, txt = client.mgr_command({"prefix": "pg dump"})
                if rc == 0 and json.loads(txt)["num_pgs"] \
                        == sum(pools.values()):
                    return {"num_pgs": json.loads(txt)["num_pgs"],
                            "refill_seconds":
                                time.perf_counter() - promoted}
                if time.time() > deadline:
                    raise SmokeFailure(f"13a: mgr.1 not serving pg dump "
                                       f"(rc {rc} {txt[:200]})")
                time.sleep(0.1)
        sub("6_failover", failover)

        # 7. every object read back
        def read():
            def same(name, comp_):
                if comp_.reply.ops[0].data != payload[name]:
                    raise SmokeFailure(f"13a: {name} read back != the "
                                       f"bytes written")
            secs = sum(_rados_bench(names[pid], ios[pid].aio_read, same)
                       for pid in pools)
            return {"MB_s": mb / secs}
        sub("7_read", read)

        deadline = time.time() + CLUSTER_RECOVERY_S
        t0 = time.perf_counter()
        while True:
            mon_h = json.loads(client.mon_command({"prefix": "health"})[1])
            mgr_h = mgrs[1].health()
            if mon_h["status"] == mgr_h["status"] == "HEALTH_OK":
                break
            if time.time() > deadline:
                raise SmokeFailure(f"13a: health {mon_h} / {mgr_h}")
            time.sleep(0.2)
        out["health_ok_seconds"] = time.perf_counter() - t0
        check(True, f"13a: HEALTH_OK from the mon and mgr.1 "
              f"({out['health_ok_seconds']:.1f} s after the reads)")
        for ctx_ in contexts:
            assert_no_faults(f"13a: {ctx_.name}", ctx_.fault_digest())
    finally:
        tap.close()
        c.stop()
        for ctx_ in contexts:
            ctx_.stop()
    ctx_names = {ctx_.name for ctx_ in contexts}
    c = client = contexts = mgrs = None
    gc.collect()
    deadline = time.time() + 10
    alive = []
    while time.time() < deadline:
        alive = [t.name for t in threading.enumerate() if t.is_alive()
                 and t.name.split("-")[0] in ctx_names]
        if not alive:
            break
        time.sleep(0.05)
    check(not alive, f"13a: no engine thread alive after stop() "
          f"({alive[:4]})")
    return out


def mgr_balancer(dev, tag: str, mapped: dict, launches: dict) -> dict:
    """Phase 13b: calc_pg_upmaps on phase 9's map at e4 in phase 9's
    context's mapping service, pool by pool (see the module docstring).
    Fills ``launches`` with pg_finish_ladder's what-if launches by pool."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from ceph_tpu_torch import balancer as bal
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import placement_cuda as pc
    from ceph_tpu_torch.ops import placement_kernel as pk
    card = dev.type == "cuda"
    ctx, m4 = mapped["ctx"], mapped["map"]
    svc = ctx.mapping_service()
    tap = _WhatIfTap()
    out: dict = {"pools": {}}
    changes: dict = {}
    real_hist = bal._histogram
    hist_s = [0.0]

    def timed_hist(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real_hist(*a, **kw)
        finally:
            hist_s[0] += time.perf_counter() - t0

    bal._histogram = timed_hist
    try:
        spread0 = _spreads(bal, m4, sorted(m4.pools), service=svc)
        for pid in sorted(m4.pools):
            pool = m4.pools[pid]
            n0, hist_s[0] = len(tap.batches), 0.0
            _build.reset_launches()
            t0 = time.perf_counter()
            got = bal.calc_pg_upmaps(m4, pool_ids=[pid], service=svc)
            secs = time.perf_counter() - t0
            lad = _build.LAUNCHES["pg_finish_ladder"]
            recs = tap.since(n0)
            wi_s = sum(r["seconds"] for r in recs)
            split = {"seconds": secs, "histogram_s": hist_s[0],
                     "what_if_s": wi_s,
                     "host_loop_s": secs - hist_s[0] - wi_s}
            held, err = tap.hold(recs, dev)
            ctx.conf.set("osdmap_mapping_fused", False)
            try:
                n1 = len(tap.batches)
                t1 = time.perf_counter()
                twin = bal.calc_pg_upmaps(m4, pool_ids=[pid], service=svc)
                twin_s = time.perf_counter() - t1
                off = tap.since(n1)
            finally:
                ctx.conf.set("osdmap_mapping_fused", True)
            cands = sorted(r["candidates"] for r in recs)
            print(f"13b pool {pid} (pg_num {pool.pg_num}, W={pool.size}): "
                  f"plan {secs:.3f} s = histogram "
                  f"{split['histogram_s']:.3f} + what_if_up {wi_s:.3f} "
                  f"({len(recs)} calls) + host loop "
                  f"{split['host_loop_s']:.3f}; pg_finish_ladder launches "
                  f"{lad}, candidates a launch median "
                  f"{statistics.median(cands) if cands else 0} (min "
                  f"{cands[0] if cands else 0}, max "
                  f"{cands[-1] if cands else 0}); {len(got)} changes; the "
                  f"fused-off twin {twin_s:.3f} s  {tag}")
            check(all(r["scored"] for r in recs) and held >= len(recs)
                  and (lad >= max(1, len(recs)) or not card),
                  f"13b pool {pid}: every what_if_up batch scored by the "
                  f"fused ladder ({len(recs)} batches, {lad} launches)")
            check(err == 0, f"13b pool {pid}: every what_if_up batch "
                  f"({held} ladders) == ladder_plain on the card")
            check(twin == got and not any(r["scored"] for r in off),
                  f"13b pool {pid}: the plan ({len(got)} changes) equals "
                  f"the plan with osdmap_mapping_fused off (every score "
                  f"from up_of on the host)")
            row = {"pg_num": pool.pg_num, "W": pool.size, "changes": len(got),
                   "split": split, "launches": lad,
                   "candidates": {"batches": len(cands),
                                  "median": statistics.median(cands)
                                  if cands else 0,
                                  "min": cands[0] if cands else 0,
                                  "max": cands[-1] if cands else 0},
                   "fused_off_seconds": twin_s}
            if card and recs:
                mid = [r for r in recs
                       if r["candidates"] == cands[len(cands) // 2]][0]
                op, fut = mid["ladders"][0]
                packed = np.asarray(fut.result(timeout=60))
                t = on_card(op, dev)
                words = pc.osd_words(*t[9:12])
                buf = torch.empty((op.raw.shape[0], 2 * op.width + 4),
                                  dtype=torch.int32, device=dev)
                g, h = paired_times(
                    lambda: launch_ladder(t, words, op.erasure, buf), 20)
                plain_ms = time_ms(lambda: pk.ladder_plain(
                    *t, erasure=op.erasure), 1, reps=5)
                b_ms, b_by = ladder_bound(op, packed)
                ms, host = statistics.median(g), statistics.median(h)
                check(torch.equal(buf.cpu(), torch.from_numpy(packed)),
                      f"13b pool {pid}: the raw launch wrote the batch's "
                      f"rows")
                row["kernel"] = {"shape": f"N={op.raw.shape[0]} "
                                 f"W={op.width} P={op.items.shape[1]}",
                                 "ms": ms, "host_ms": host,
                                 "plain_ms": plain_ms, "bound_ms": b_ms,
                                 "bound_by": b_by}
                print(f"13b pool {pid}: pg_finish_ladder at the median "
                      f"what-if batch {row['kernel']['shape']}: {ms:.4f} ms "
                      f"(graph replay; {host:.4f} issued)  plain "
                      f"{plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
                      f"{tag}")
            launches[f"13b pool {pid}"] = lad
            out["pools"][str(pid)] = row
            changes.update(got)
    finally:
        bal._histogram = real_hist
        tap.close()
    m6 = m4.copy()
    m6.epoch = 6
    for pgid, pairs in changes.items():
        if pairs:
            m6.pg_upmap_items[pgid] = pairs
        else:
            m6.pg_upmap_items.pop(pgid, None)
    _build.reset_launches()
    t0 = time.perf_counter()
    svc.update_to(m6)
    upd_s = time.perf_counter() - t0
    spread1 = _spreads(bal, m6, sorted(m6.pools), service=svc)
    print(f"13b: the plans applied as epoch 6 (update_to {upd_s:.3f} s, "
          f"launches {({k: v for k, v in _build.LAUNCHES.items() if v})}); "
          f"(min, max) PGs an OSD by pool {spread0} -> {spread1}  {tag}")
    check(all(spread1[p][1] - spread1[p][0] <= spread0[p][1] - spread0[p][0]
              for p in m6.pools),
          f"13b: neither pool's spread is wider after the epoch")
    rng = np.random.default_rng(1317)
    moved = sorted(changes)
    keys = [moved[i] for i in sorted(rng.choice(
        len(moved), min(MGR_ORACLE, len(moved)), replace=False))]
    ctx_mp = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx_mp) as pool_exec:
        oracle = scalar_oracle(pool_exec, m6, keys)
    bad = [k for k in keys if svc.lookup(m6, *k) != oracle[k]]
    check(keys and not bad, f"13b: the moved PGs' up/acting == "
          f"pg_to_up_acting_osds on a seeded {len(keys)} of {len(moved)} "
          f"(oracle {time.perf_counter() - t0:.1f} s) {bad[:3]}")
    assert_no_faults("13b", ctx.fault_digest())
    out.update(spread_before=spread0, spread_after=spread1,
               update_to_seconds=upd_s, oracle_checked=len(keys))
    return out


def mgr_phase(dev, tag: str, mapped: dict) -> tuple[dict, dict]:
    """Phase 13: the manager (13a) and the balancer at full width (13b);
    returns the {"mgr": ...} summary and pg_finish_ladder's balancer
    launches by sub-step and pool.  Stops phase 9's context."""
    t_phase = time.perf_counter()
    steps: dict = {}
    launches: dict = {}
    try:
        print("-- 13a. the manager on a MiniCluster")
        cluster = mgr_cluster(dev, tag, steps)
        launches.update({f"13a {k}": v["launches"].get("pg_finish_ladder", 0)
                         for k, v in steps.items()})
        print("-- 13b. the balancer on phase 9's map")
        full = mgr_balancer(dev, tag, mapped, launches)
    finally:
        mapped["ctx"].stop()
    secs = time.perf_counter() - t_phase
    print(f"mgr: phase 13 took {secs:.1f} s (budget {MGR_BUDGET_S:.0f} s)  "
          f"{tag}")
    return ({"cluster": cluster, "steps": steps, "balancer": full,
             "phase_seconds": secs, "budget_seconds": MGR_BUDGET_S},
            launches)


def _plain_shards(stores, osdmap, pool: int, name: str, payload: bytes,
                  tab, k: int, m: int, dev) -> int:
    """One object's stored shards == its stripes and their parity by
    gf_matvec's plain version on ``dev`` (``_check_shards``)."""
    import numpy as np
    import torch

    from ceph_tpu_torch.ops import gf_kernel as gk
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    stripes = torch.from_numpy(StripeInfo(k, CLUSTER_STRIPE_UNIT).split(
        np.frombuffer(payload, dtype=np.uint8))).to(dev)
    pidx = torch.zeros((stripes.shape[0],), dtype=torch.int32, device=dev)
    parity = gk.gf_matvec_plain(tab, pidx, stripes, m)
    full = torch.cat([stripes, parity], dim=1).cpu().numpy()
    return _check_shards(stores, osdmap, pool, name, full, k,
                         "its bytes by gf_matvec's plain version")


def _ec_generator(k: int, m: int):
    from ceph_tpu_torch.ec import registry_instance
    return registry_instance().factory(
        "jerasure", {"k": str(k), "m": str(m), "technique": "reed_sol_van",
                     "runtime": "cpu"}, device="cpu").generator


def _payloads(dev, names, obj_bytes: int, seed: int) -> dict:
    import torch
    gen_ = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for lo in range(0, len(names), 16):
        block = torch.randint(0, 256, (min(16, len(names) - lo), obj_bytes),
                              dtype=torch.uint8, device=dev,
                              generator=gen_).cpu().numpy()
        for j, row in enumerate(block):
            out[names[lo + j]] = row.tobytes()
    return out


def tcp_cluster(dev, tag: str, loopback: dict | None,
                n_objects: int = TCP_OBJECTS,
                obj_bytes: int = CLUSTER_OBJ_BYTES) -> tuple[dict, dict]:
    """14a: phase 10's cluster over the event TCP stack with cephx, on
    BlueStore.  Returns its summary and gf_matvec's and scrub_digest's
    launches by sub-step."""
    import shutil
    import tempfile

    import torch

    from ceph_tpu_torch.msg.event_tcp import EventMessenger
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import gf_kernel as gk
    from ceph_tpu_torch.tools.vstart import MiniCluster
    on_card = dev.type == "cuda"
    k, m = CLUSTER_K, CLUSTER_M
    root = tempfile.mkdtemp(prefix="chip_smoke_tcp_")
    names = [f"tcp_{i:04d}" for i in range(n_objects)]
    payload = _payloads(dev, names, obj_bytes, 14)
    total_mb = n_objects * obj_bytes / 1e6
    tab = torch.from_numpy(gk.pack_rows(_ec_generator(k, m)[k:][None])) \
        .to(dev)
    steps: dict = {}
    launches: dict = {}
    t0 = time.perf_counter()
    c = MiniCluster(n_osds=CLUSTER_OSDS, ms_type="async", cephx=True,
                    store_type="bluestore",
                    base_path=os.path.join(root, "cluster"),
                    device=dev).start()
    contexts = []
    try:
        c.wait_for_osd_count(CLUSTER_OSDS, timeout=CLUSTER_OP_TIMEOUT)
        client = c.client(timeout=CLUSTER_OP_TIMEOUT)
        contexts = [c.mon.ctx, client.ctx] + [o.ctx for o in c.osds.values()]
        start_s = time.perf_counter() - t0
        pool = c.create_pool(client, pool_type="erasure", plugin="jerasure",
                             technique="reed_sol_van", k=k, m=m,
                             pg_num=CLUSTER_PG_NUM,
                             epoch_timeout=CLUSTER_OP_TIMEOUT)
        peer_s = _wait_active(c, pool, CLUSTER_PG_NUM, CLUSTER_OP_TIMEOUT)
        daemons = [*c.osds.values(), c.mon, client]
        check(all(isinstance(d.msgr, EventMessenger) and d.msgr.cephx
                  is not None for d in daemons),
              f"14a: the mon, {CLUSTER_OSDS} OSDs and the client on the "
              f"event TCP stack, each with cephx; started in {start_s:.1f} "
              f"s, the pool's {CLUSTER_PG_NUM} PGs active {peer_s:.1f} s "
              f"after its creation")
        ents = {con.auth_entity for con in c.mon.msgr._conns.values()
                if con.auth_entity}
        check(sum(e.startswith("osd.") for e in ents) == CLUSTER_OSDS
              and "client.admin" in ents,
              f"14a: the mon's sessions carry the OSDs' and the client's "
              f"cephx identities ({len(ents)})")
        io = client.open_ioctx(pool)

        def step(label, body):
            _build.reset_launches()
            secs = body()
            if on_card:
                torch.cuda.synchronize()
            rec = {"seconds": secs, "MB_s": total_mb / secs,
                   "gf_matvec_launches": _build.LAUNCHES["gf_matvec"],
                   "scrub_digest_launches": _build.LAUNCHES["scrub_digest"]}
            steps[label] = rec
            launches[label] = {"gf_matvec": rec["gf_matvec_launches"],
                               "scrub_digest": rec["scrub_digest_launches"]}
            ref = ((loopback or {}).get("sub_phases", {})
                   .get({"14a_write": "10a_write", "14a_read": "10b_read",
                         "14a_degraded_read": "10c_degraded_read"}[label],
                        {}).get("MB_s"))
            print(f"tcp {label}: {total_mb:.1f} MB in {secs:.3f} s = "
                  f"{rec['MB_s']:.1f} MB/s (host clock; phase 10 on "
                  f"loopback and memstore: "
                  + (f"{ref:.1f} MB/s" if ref else "not run")
                  + f"); launches gf_matvec {rec['gf_matvec_launches']}, "
                  f"scrub_digest {rec['scrub_digest_launches']}  {tag}")
            return rec

        def check_read(name, comp):
            if comp.reply.ops[0].data != payload[name]:
                raise SmokeFailure(f"14a: {name} read back != the bytes "
                                   f"written")

        def read_all():
            return _rados_bench(names, io.aio_read, check_read)

        step("14a_write", lambda: _rados_bench(
            names, lambda n: io.aio_write_full(n, payload[n]),
            lambda n, comp: None))
        stores = {i: o.store for i, o in c.osds.items()}
        sample = names[:: max(1, n_objects // CLUSTER_SAMPLE)][
            :CLUSTER_SAMPLE]
        held = sum(_plain_shards(stores, c.mon.osdmap, pool, n, payload[n],
                                 tab, k, m, dev) for n in sample)
        check(not on_card or (launches["14a_write"]["gf_matvec"] >= 1 and
                              launches["14a_write"]["scrub_digest"] >= 1),
              f"14a: the writes launched gf_matvec and scrub_digest; "
              f"{len(sample)} sampled objects' {held} shards == their "
              f"stripes and gf_matvec's plain version on the card, hinfo "
              f"matching")
        step("14a_read", read_all)
        check(True, f"14a: all {n_objects} objects read back byte-equal")
        c.kill_osd(CLUSTER_VICTIM)
        rc, out = client.mon_command({"prefix": "osd down",
                                      "id": str(CLUSTER_VICTIM)})
        check(rc == 0, f"14a: osd down {CLUSTER_VICTIM}: {out}")
        epoch = c.mon.osdmap.epoch
        c.wait_for_epoch(epoch, timeout=CLUSTER_OP_TIMEOUT)
        client.wait_for_epoch(epoch)
        rec = step("14a_degraded_read", read_all)
        check(not on_card or rec["gf_matvec_launches"] >= 1,
              f"14a: degraded reads decode through gf_matvec "
              f"({rec['gf_matvec_launches']} launches); all {n_objects} "
              f"objects byte-equal")
        for ctx in contexts:
            assert_no_faults(f"14a: {ctx.name}", ctx.fault_digest())
    finally:
        c.stop()
        shutil.rmtree(root, ignore_errors=True)
    summary = {"osds": CLUSTER_OSDS, "k": k, "m": m,
               "pg_num": CLUSTER_PG_NUM, "objects": n_objects,
               "object_bytes": obj_bytes, "in_flight": CLUSTER_IN_FLIGHT,
               "ms_type": "async", "cephx": True, "store": "bluestore",
               "start_seconds": start_s, "pool_peering_seconds": peer_s,
               "sub_steps": steps}
    return summary, launches


def _card_memory() -> dict:
    """pid -> MiB the card holds for it (nvidia-smi's compute apps)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout
    mem = {}
    for line in out.strip().splitlines():
        pid, _, mib = line.partition(",")
        if pid.strip().isdigit():
            mem[int(pid)] = mib.strip()
    return mem


def _card_used_mib() -> float:
    """MiB of the card in use, by every process (cudaMemGetInfo)."""
    import torch
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 2 ** 20


def proc_cluster(dev, tag: str, n_objects: int = TCP_PROC_OBJECTS,
                 more: int = TCP_PROC_MORE,
                 obj_bytes: int = CLUSTER_OBJ_BYTES) -> dict:
    """14b: daemons as processes (ProcCluster on ``dev``): a mon and
    TCP_PROC_OSDS OSDs on FileStore, an EC pool; writes, reads, a SIGKILL,
    more writes, reads, the restart until recovered; after stop() each
    OSD's FileStore opened here and every object's shards held against
    gf_matvec's plain version on ``dev``."""
    import shutil
    import tempfile
    import threading

    import torch

    from ceph_tpu_torch.objectstore import create_objectstore
    from ceph_tpu_torch.ops import gf_kernel as gk
    from ceph_tpu_torch.tools.vstart import ProcCluster
    k, m = TCP_PROC_K, TCP_PROC_M
    root = tempfile.mkdtemp(prefix="chip_smoke_proc_")
    names = [f"proc_{i:04d}" for i in range(n_objects + more)]
    payload = _payloads(dev, names, obj_bytes, 15)
    tab = torch.from_numpy(gk.pack_rows(_ec_generator(k, m)[k:][None])) \
        .to(dev)
    pc = ProcCluster(n_osds=0, base_path=root, device=dev.type)
    ready: dict = {}
    steps: dict = {}
    on_card = dev.type == "cuda"
    used0 = _card_used_mib() if on_card else 0.0
    try:
        t0 = time.perf_counter()
        pc.start()
        ready["mon.0"] = time.perf_counter() - t0
        errors: list = []

        def spawn(i):
            t = time.perf_counter()
            try:
                pc.run_osd(i)
            except Exception as e:      # reported below, fails the phase
                errors.append(e)
            ready[f"osd.{i}"] = time.perf_counter() - t
        threads = [threading.Thread(target=spawn, args=(i,))
                   for i in range(TCP_PROC_OSDS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise SmokeFailure(f"14b: {errors[0]}")
        client = pc.client(timeout=CLUSTER_OP_TIMEOUT)
        pc.wait_for_osd_count(TCP_PROC_OSDS, timeout=CLUSTER_OP_TIMEOUT)
        start_s = time.perf_counter() - t0
        print(f"tcp 14b: a mon and {TCP_PROC_OSDS} OSD processes up in "
              f"{start_s:.1f} s; seconds from spawn to ready: "
              + ", ".join(f"{d} {s:.1f}" for d, s in sorted(ready.items()))
              + f"  {tag}")
        pool = pc.create_pool(client, pool_type="erasure", plugin="jerasure",
                              technique="reed_sol_van", k=k, m=m,
                              pg_num=TCP_PROC_PG_NUM)
        io = client.open_ioctx(pool)

        def check_read(name, comp):
            if comp.reply.ops[0].data != payload[name]:
                raise SmokeFailure(f"14b: {name} read back != the bytes "
                                   f"written")

        def step(label, objs, write: bool):
            if write:
                secs = _rados_bench(objs, lambda n: io.aio_write_full(
                    n, payload[n]), lambda n, comp: None)
            else:
                secs = _rados_bench(objs, io.aio_read, check_read)
            mb = len(objs) * obj_bytes / 1e6
            steps[label] = {"objects": len(objs), "seconds": secs,
                            "MB_s": mb / secs}
            print(f"tcp {label}: {mb:.1f} MB in {secs:.3f} s = "
                  f"{mb / secs:.1f} MB/s (host clock)  {tag}")

        first, later = names[:n_objects], names[n_objects:]
        step("14b_write", first, True)
        step("14b_read", first, False)
        mem = _card_memory() if on_card else {}
        card_mib = {d: mem.get(p.pid, "not listed")
                    for d, p in sorted(pc.procs.items())}
        daemons_mib = (_card_used_mib() - used0) if on_card else None
        print(f"tcp 14b: card memory by process (MiB, nvidia-smi "
              f"--query-compute-apps): {card_mib}, listed pids "
              f"{sorted(mem)} (" + ("each daemon's pid listed"
                                    if all(v != "not listed" for v in
                                           card_mib.values())
                                    else "pids of another namespace: not "
                                    "attributable") + "); the card's use "
              f"grew by " + (f"{daemons_mib:.0f} MiB, "
                             f"{daemons_mib / len(pc.procs):.0f} MiB a "
                             f"daemon process" if on_card else
                             "not measured")
              + f" (cudaMemGetInfo before the spawn and after the reads)"
              f"  {tag}")
        victim = TCP_PROC_VICTIM
        pc.kill_osd(victim)
        rc, out = client.mon_command({"prefix": "osd down",
                                      "id": str(victim)})
        check(rc == 0, f"14b: osd.{victim} killed by SIGKILL, marked down: "
              f"{out}")
        step("14b_write_degraded", later, True)
        step("14b_read_degraded", names, False)
        check(True, f"14b: {len(later)} objects written with osd.{victim} "
              f"down; all {len(names)} read back byte-equal")

        def health():
            rc_, out_ = client.mon_command({"prefix": "health"})
            return json.loads(out_) if rc_ == 0 else {}

        t_restart = time.perf_counter()
        pc.run_osd(victim)
        ready[f"osd.{victim} restart"] = time.perf_counter() - t_restart
        pc.wait_for_osd_count(TCP_PROC_OSDS, timeout=CLUSTER_OP_TIMEOUT)
        deadline = time.time() + CLUSTER_RECOVERY_S
        ok_since = None
        while True:
            now = time.perf_counter()
            if health().get("status") == "HEALTH_OK":
                ok_since = ok_since or now
                if now - ok_since >= 2.0:    # two OSD ticks of reports
                    break
            else:
                ok_since = None
            if time.time() > deadline:
                raise SmokeFailure(f"14b: osd.{victim} restarted but the "
                                   f"cluster not HEALTH_OK after "
                                   f"{CLUSTER_RECOVERY_S} s: {health()}")
            time.sleep(0.25)
        recovered_s = ok_since - t_restart
        print(f"tcp 14b: osd.{victim} restarted on its FileStore; "
              f"HEALTH_OK {recovered_s:.1f} s after the restart (spawn to "
              f"ready {ready[f'osd.{victim} restart']:.1f} s)  {tag}")
        osdmap = client.osdmap
        step("14b_read_recovered", names, False)
        cli = cli_bench(pc.mon_host, pool, dev, tag)
    finally:
        pc.stop()
    try:
        stores = {}
        for i in range(TCP_PROC_OSDS):
            st = create_objectstore("filestore", f"{root}/osd.{i}")
            st.mount()
            stores[i] = st
        held = sum(_plain_shards(stores, osdmap, pool, n, payload[n], tab,
                                 k, m, dev) for n in names)
        check(held == len(names) * (k + m),
              f"14b: after stop(), each OSD's FileStore opened here: all "
              f"{held} shards of the {len(names)} objects on the OSDs the "
              f"map names, == their stripes and gf_matvec's plain version "
              f"on the card, hinfo matching (osd.{victim}'s recovered)")
        for st in stores.values():
            st.umount()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"osds": TCP_PROC_OSDS, "k": k, "m": m,
            "pg_num": TCP_PROC_PG_NUM, "objects": len(names),
            "object_bytes": obj_bytes, "in_flight": CLUSTER_IN_FLIGHT,
            "store": "filestore", "spawn_to_ready_seconds": ready,
            "start_seconds": start_s, "card_memory_MiB": card_mib,
            "card_memory_growth_MiB": daemons_mib,
            "restart_to_recovered_seconds": recovered_s,
            "sub_steps": steps, "rados_bench_cli": cli,
            "launches": "not counted: the kernels launch in the OSD "
                        "processes"}


def cli_bench(mon_host: str, pool: int, dev, tag: str) -> dict:
    """14b's rados bench CLI: ``python -m ceph_tpu_torch.tools.rados_bench``
    as a process of its own on ``dev`` against the daemon processes, a
    write run of TCP_CLI_S seconds with CLUSTER_IN_FLIGHT in flight, then a
    seq run over what it wrote; each JSON line parsed and printed, its exit
    code 0 and errors 0.  Its launches are not counted: the kernels launch
    in the OSD processes."""
    root = os.path.dirname(os.path.abspath(__file__))
    out: dict = {}
    n = 0
    for mode in ("write", "seq"):
        cmd = [sys.executable, "-m", "ceph_tpu_torch.tools.rados_bench",
               "--mon", mon_host, "-p", str(pool), str(TCP_CLI_S), mode,
               "-t", str(CLUSTER_IN_FLIGHT), "--device", dev.type]
        if mode == "seq":
            cmd += ["--n-objects", str(n)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=CLUSTER_OP_TIMEOUT)
        secs = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            raise SmokeFailure(f"14b: rados bench {mode} exited "
                               f"{proc.returncode}: {proc.stderr[-2000:]}")
        res = json.loads(lines[-1])
        res["process_seconds"] = secs
        out[mode] = res
        print(f"tcp 14b: rados bench {mode} (CLI, its own process on "
              f"{dev.type}, {secs:.1f} s from spawn to exit): "
              f"{json.dumps(res)}  {tag}")
        check(res["errors"] == 0 and res["total_writes_or_reads"] > 0,
              f"14b: rados bench {mode} exited 0, "
              f"{res['total_writes_or_reads']} ops, errors 0")
        if mode == "write":
            n = res["total_writes_or_reads"]
    return out


def tcp_phase(dev, tag: str, loopback: dict | None) -> tuple[dict, dict]:
    """Phase 14: 14a and 14b (see the docstring).  Returns the {"tcp": ...}
    summary and 14a's launches by sub-step."""
    t_phase = time.perf_counter()
    a, launches = tcp_cluster(dev, tag, loopback)
    b = proc_cluster(dev, tag)
    secs = time.perf_counter() - t_phase
    print(f"tcp: phase 14 took {secs:.1f} s (budget {TCP_BUDGET_S:.0f} s)"
          f"  {tag}")
    return ({"14a_cluster_over_tcp": a, "14b_processes": b,
             "phase_seconds": secs, "budget_seconds": TCP_BUDGET_S},
            launches)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def sm_clock_hz() -> float | None:
    """The card's maximum SM clock from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0]) * 1e6
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _event_times(run, per: int, reps: int) -> list[float]:
    """``reps`` CUDA-event times of ``run()``, each over ``per``."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return times


def host_times(fn, iters: int, reps: int = 7) -> list[float]:
    """Per-call times of ``iters`` back-to-back calls issued from Python,
    by CUDA events, after one warm call: for a launch shorter than the host's
    own cost per call, the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _event_times(run, iters, reps)


def _capture(fn, iters: int):
    """``iters`` launches of ``fn`` captured once into a CUDA graph, after
    one warm call outside the capture, and replayed once.  A capture that
    fails raises."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return g


def graph_times(fn, iters: int, reps: int = 7) -> list[float]:
    """Per-launch times of ``iters`` launches of ``fn`` captured into a CUDA
    graph and replayed, by CUDA events: the card's time, without the host's
    cost per launch."""
    return _event_times(_capture(fn, iters).replay, iters, reps)


def paired_times(fn, iters: int, reps: int = 7
                 ) -> tuple[list[float], list[float]]:
    """``graph_times`` and ``host_times`` of ``fn`` taken in turns, one rep
    of each at a time, so that a drift of the card's state during the
    measurement falls on both alike."""
    g = _capture(fn, iters)

    def issue():
        for _ in range(iters):
            fn()
    graph, host = [], []
    for _ in range(reps):
        graph += _event_times(g.replay, iters, 1)
        host += _event_times(issue, iters, 1)
    return graph, host


#: cycles of the spin kernel queued ahead of a timed replay (~100 us at the
#: H100's 1.98 GHz), so that the card is busy while the host submits it
SPIN_CYCLES = 200_000


def queued_graph_times(fn, iters: int, reps: int = 7) -> list[float]:
    """``graph_times`` with a spin kernel (SPIN_CYCLES) queued ahead of each
    timed replay: the card's time of the launches alone, without its wait
    for the host to submit the replay."""
    import torch
    g = _capture(fn, iters)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return times


def time_ms(fn, iters: int, reps: int = 7) -> float:
    """Median of ``host_times``."""
    return statistics.median(host_times(fn, iters, reps))


def graph_ms(fn, iters: int, reps: int = 7) -> float:
    """Median of ``graph_times``."""
    return statistics.median(graph_times(fn, iters, reps))


def _union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def profile_window(fn, calls: int = 3) -> dict:
    """torch.profiler (CPU and CUDA activities) over ``calls`` warm calls of
    ``fn``: the window's length, the card's busy time (the union of its
    kernel, copy and fill intervals), their share, and device time by kernel
    name; ``device_ms`` is 0 when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    by_name: dict[str, float] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + (e.time_range.end - e.time_range.start) / 1e3
    busy = _union(spans)
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) if events else 0.0
    avg = prof.key_averages()
    device_ms = sum(getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0)
                    for e in avg) / 1e3
    return {"calls": calls, "window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / window if window else 0.0,
            "device_ms": device_ms,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS32_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ladder_work(hw, lw, xs, rw, numrep: int, tries: int) -> dict:
    """What the consume kernel's ladder needs on these columns, summed over
    inputs: ``rows`` — the distinct rows read (an input reads rows 0 .. its
    furthest attempt); ``attempts`` — rows read, a row read by two replicas
    twice; ``judged`` — attempts free of collisions, whose reweight is
    loaded, and ``ids_judged`` the distinct devices among them; ``hashed``
    — judged attempts with a weight in (0, 0x10000).  Replica rep reads rows
    rep .. rep + attempts - 1."""
    import torch
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.ops.crush_kernel import is_out
    R, n = hw.shape
    dev = hw.device
    lb = is_out(rw, lw, xs[None, :])
    lid = lw.long()
    inside = (lid >= 0) & (lid < rw.shape[0])
    w = torch.where(inside, rw[lid.clamp(0, rw.shape[0] - 1)], 0)
    partial = inside & (w > 0) & (w < 0x10000)
    none = torch.full((n,), CRUSH_ITEM_NONE, dtype=torch.int32, device=dev)
    sel_h = [none.clone() for _ in range(numrep)]
    sel_l = [none.clone() for _ in range(numrep)]
    last = torch.zeros((n,), dtype=torch.int64, device=dev)
    attempts = judged = hashed = 0
    seen = torch.zeros((rw.shape[0],), dtype=torch.bool, device=dev)
    for rep in range(numrep):
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        for i in range(min(tries, R - rep)):
            r = rep + i
            coll = torch.zeros((n,), dtype=torch.bool, device=dev)
            for j in range(numrep):
                coll = coll | (sel_h[j] == hw[r]) | (sel_l[j] == lw[r])
            act = ~done
            last = torch.where(act, last.clamp(min=r), last)
            judge = act & ~coll & inside[r]
            attempts += int(act.sum())
            judged += int(judge.sum())
            hashed += int((judge & partial[r]).sum())
            seen[lid[r][judge]] = True
            place = act & ~coll & ~lb[r]
            sel_h[rep] = torch.where(place, hw[r], sel_h[rep])
            sel_l[rep] = torch.where(place, lw[r], sel_l[rep])
            done = done | place
    return {"rows": int((last + 1).sum()), "attempts": attempts,
            "judged": judged, "ids_judged": int(seen.sum()),
            "hashed": hashed}


def consume_bound(work: dict, n: int, numrep: int) -> tuple[float, str]:
    """The consume kernel's bound from ``ladder_work``: bytes — x, the rows
    read, the reweights of the devices judged, the selections and the flag
    —, operations — the collision compares of every attempt, the verdict's
    compares of every judged one and hash32_2 of every hashed one."""
    return bound(4 * n + 8 * work["rows"] + 8 * work["ids_judged"]
                 + 8 * numrep * n + 4 * n,
                 work["attempts"] * (2 * numrep + 2) + work["judged"] * 4
                 + work["hashed"] * HASH2_OPS)


def bench_map(n_hosts: int = 250, per_host: int = 40):
    """bench.py's CRUSH map: 250 hosts x 40 OSDs, seed-42 weight skew,
    10% of OSDs reweighted to 0.5 and 2% out; the same recipe at another
    host count and width."""
    import numpy as np
    from ceph_tpu_torch.crush.builder import build_two_level_map
    crush_map, _root, rid = build_two_level_map(n_hosts, per_host)
    n_osds = n_hosts * per_host
    wrng = np.random.default_rng(42)
    for b in crush_map.buckets:
        if b is not None and b.type == 1:      # host level: skew weights
            b.item_weights = [int(w) for w in
                              wrng.integers(0x8000, 0x20000, b.size)]
            b.weight = sum(b.item_weights)
    root = crush_map.bucket(-1)
    root.item_weights = [crush_map.bucket(h).weight for h in root.items]
    root.weight = sum(root.item_weights)
    reweight = np.full(n_osds, 0x10000, dtype=np.int64)
    idx = wrng.permutation(n_osds)
    reweight[idx[:n_osds // 10]] = 0x8000
    reweight[idx[n_osds // 10:n_osds // 10 + n_osds // 50]] = 0
    return crush_map, rid, reweight


def synthetic_root(weights, seed: int):
    """A FastRule-like root of len(weights) items (ids -2, -3, ...) and no
    leaf level, for CudaColumns."""
    import types
    import numpy as np
    ids = -2 - np.random.default_rng(seed).permutation(len(weights))
    return types.SimpleNamespace(
        root_ids=ids.astype(np.int32), root_w=np.asarray(weights, np.int64),
        leaf_ids=None, leaf_w=None, vary_r=0)


def synthetic_leaf(rows_w, seed: int, vary_r: int):
    """A FastRule-like chooseleaf rule whose (H, S) host rows hold
    ``rows_w`` (device ids 0 .. H*S-1, shuffled), under a root of H hosts
    weighted by their rows' sums (1 for a row of zeros)."""
    import types
    import numpy as np
    rows_w = np.asarray(rows_w, np.int64)
    H, S = rows_w.shape
    rng = np.random.default_rng(seed)
    return types.SimpleNamespace(
        root_ids=(-2 - rng.permutation(H)).astype(np.int32),
        root_w=np.maximum(rows_w.sum(axis=1), 1),
        leaf_ids=rng.permutation(H * S).reshape(H, S).astype(np.int32),
        leaf_w=rows_w, vary_r=vary_r)


def hold_leaf(cols, xs, R: int, what: str, same, root_pos=None) -> None:
    """The leaf kernel on ``cols``' host rows against its plain version,
    on the card, on the root kernel's positions unless ``root_pos`` is
    given: leaf ids exact."""
    from ceph_tpu_torch.ops import straw2_cuda as sc
    n, S = xs.shape[0], cols.leaf_ids.shape[1]
    if root_pos is None:
        root_pos = cols.root_columns(xs, None, R)[0]
    G = sc.card_group_lanes(n * R, S, xs.device)
    same("straw2_leaf", cols.leaf_columns(xs, root_pos, R),
         sc.leaf_columns_plain(xs, root_pos, cols.leaf_ids, cols.leaf_w,
                               cols.fr.vary_r, R),
         f"leaf kernel == plain, {what}, N={n} R={R} S={S} G={G}")


def hold_roots(cols, xs, R: int, what: str, same, kernels) -> None:
    """The root kernels named in ``kernels`` (straw2_root, straw2_froot)
    on ``cols``' root against their plain versions, on the card:
    positions, ids and filter flags exact."""
    from ceph_tpu_torch.ops import straw2_cuda as sc
    from ceph_tpu_torch.ops import straw2_filter as sf
    n, S = xs.shape[0], cols.root_ids.shape[0]
    G = sc.card_group_lanes(n * R, S, xs.device)
    shape = f"{what}, N={n} R={R} S={S} G={G}"
    if "straw2_root" in kernels:
        pos, ids = cols.root_columns(xs, None, R)
        ppos, pids = sc.root_columns_plain(xs, cols.root_ids, cols.root_w, R)
        same("straw2_root", pos, ppos, f"root kernel positions == plain, "
             f"{shape}")
        same("straw2_root", ids, pids, f"root kernel ids == plain, {what}")
    if "straw2_froot" in kernels:
        fpos, fids, fovf = cols.froot_columns(xs, None, R)
        qpos, qids, qovf = sf.froot_columns_plain(
            xs, cols.root_ids, cols.root_w, R, sf.ln_f32_table(xs.device),
            sf.ln_f32_bound(xs.device))
        same("straw2_froot", fpos, qpos, f"filter kernel positions == "
             f"plain, {shape}")
        same("straw2_froot", fids, qids, f"filter kernel ids == plain, "
             f"{what}")
        same("straw2_froot", fovf, qovf, f"filter kernel flags == plain, "
             f"{what} ({int(fovf.sum())} flagged)")


def launch_root(cols, x32, n: int, R: int, G: int, pos, ids) -> None:
    """One raw straw2_root launch on prepared operands, G lanes per
    (x, r)."""
    from ceph_tpu_torch.ops import _build
    _build.launch("straw2_root", "straw2_root_launch", x32.data_ptr(), n, R,
                  cols.root_ids.data_ptr(), cols.root_magic.data_ptr(),
                  cols.root_shift.data_ptr(), cols.root_ids.shape[0],
                  G.bit_length() - 1, cols.ln_tab.data_ptr(), pos.data_ptr(),
                  ids.data_ptr())


def launch_leaf(cols, x32, n: int, R: int, G: int, root_pos, out) -> None:
    """One raw straw2_leaf launch on prepared operands, G lanes per
    (x, r)."""
    from ceph_tpu_torch.ops import _build
    H, S = cols.leaf_ids.shape
    _build.launch("straw2_leaf", "straw2_leaf_launch", x32.data_ptr(), n, R,
                  root_pos.data_ptr(), cols.leaf_rec.data_ptr(),
                  cols.leaf_ids.data_ptr(), H, S, G.bit_length() - 1,
                  int(cols.fr.vary_r), cols.ln_tab.data_ptr(), out.data_ptr())


def launch_froot(cols, x32, n: int, R: int, G: int, D: float, table, pos,
                 ids, ovf) -> None:
    """One raw straw2_froot launch on prepared operands, G lanes per
    (x, r)."""
    from ceph_tpu_torch.ops import _build
    _build.launch("straw2_froot", "straw2_froot_launch", x32.data_ptr(), n, R,
                  cols.root_ids.data_ptr(), cols.root_magic.data_ptr(),
                  cols.root_shift.data_ptr(), cols.root_wf.data_ptr(),
                  cols.root_ids.shape[0], G.bit_length() - 1, D,
                  cols.ln_tab.data_ptr(), table.data_ptr(), pos.data_ptr(),
                  ids.data_ptr(), ovf.data_ptr())


def launch_ln(ln_tab, out, d_bits) -> None:
    """One raw ln_f32_table launch: the table into ``out`` and D's bit
    pattern into ``d_bits``."""
    from ceph_tpu_torch.ops import _build
    _build.launch("ln_f32_table", "ln_f32_table_launch", ln_tab.data_ptr(),
                  out.data_ptr(), d_bits.data_ptr(), out.shape[0])


def launch_consume(hw, lw, x32, rw, numrep: int, tries: int, threads: int,
                   out_h, out_l, ovf) -> None:
    """One raw firstn_consume launch on prepared operands."""
    from ceph_tpu_torch.ops import _build
    R, n = hw.shape
    _build.launch("firstn_consume", "firstn_consume_launch", hw.data_ptr(),
                  lw.data_ptr(), x32.data_ptr(), rw.data_ptr(), rw.shape[0],
                  R, n, numrep, tries, out_h.data_ptr(), out_l.data_ptr(),
                  ovf.data_ptr(), threads)


def launch_gf(tab, pidx, src, out) -> None:
    """One raw gf_matvec launch: ``src`` (S, k, B) times the packed table
    ``tab`` into ``out`` (S, t, B)."""
    from ceph_tpu_torch.ops import _build
    _build.launch("gf_matvec", "gf_matvec_launch", src.data_ptr(),
                  tab.data_ptr(), pidx.data_ptr(), out.data_ptr(),
                  src.shape[0], src.shape[1], out.shape[1], src.shape[2])


def gf_work(s: int, k: int, t: int, b: int, table_bytes: int
            ) -> tuple[float, str]:
    """The bound of an (S, k, B) x (t, k) product: data read and output
    written once, tables and pattern indices read once; 2 operations (a
    multiply and an add) per (stripe, output, input, byte)."""
    return bound(s * (k + t) * b + table_bytes + 4 * s, 2 * s * b * k * t)


def _ec_operand(codec, workload: str, data, lost):
    """The (t, k') matrix and the (S, k', B') device operand of one
    encode_chunks or decode_chunks call: chunks, or a bitmatrix code's
    packet rows; and the call itself on device data."""
    import torch
    from ceph_tpu_torch.ec.bitmatrix import BitmatrixCode
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    w = codec.w if isinstance(codec, BitmatrixCode) else 1
    if workload == "encode":
        mat, src = codec._coding(), data

        def call():
            return codec.encode_chunks(data)
    else:
        full = torch.cat([data, codec.encode_chunks(data)], dim=1)
        chosen = [i for i in range(n) if i not in lost][:k]
        src = full[:, chosen].contiguous()
        mat = codec._recovery(tuple(chosen), tuple(lost))

        def call():
            return codec.decode_chunks(chosen, src, list(lost))
    s, kk, b = src.shape
    return mat, src.reshape(s, kk * w, b // w).contiguous(), call


def c_crush_row(crush_map, rid: int, reweight, xs_np, placements,
                card_mpps: float, tag: str) -> dict:
    """Phase 6's one-core yardstick (bench.py:1319-1327): the port's
    native.CrushBaseline, the scalar C crush_do_rule, on the flagship map
    and rule, the first C_CRUSH_PGS of the same xs and the same reweight,
    after a C_CRUSH_WARM-x warm call; its rows == FastMapper's on the card.
    A rate of one core of the host, not of the card."""
    import numpy as np

    from ceph_tpu_torch.native import CrushBaseline, cpu_name
    cpu = cpu_name()
    c_xs = np.ascontiguousarray(xs_np[:C_CRUSH_PGS], dtype=np.uint32)
    rw = reweight.astype(np.uint32)
    cb = CrushBaseline(crush_map)
    try:
        cb.do_rule_batch(rid, c_xs[:C_CRUSH_WARM], NUMREP, rw)
        t0 = time.perf_counter()
        rows = cb.do_rule_batch(rid, c_xs, NUMREP, rw)
        secs = time.perf_counter() - t0
    finally:
        cb.close()
    c_mpps = len(c_xs) / secs / 1e6
    print(f"CRUSH C    {c_mpps:.4f} Mpps (c_crush_mpps: native.CrushBaseline,"
          f" the scalar C crush_do_rule on one core of the host CPU, {cpu}; "
          f"{len(c_xs)} PGs in {secs * 1e3:.1f} ms after a {C_CRUSH_WARM}-PG "
          f"warm call); the card's flagship call over it "
          f"{card_mpps / c_mpps:.1f}x  {tag}")
    check(np.array_equal(rows, placements[:len(c_xs)].cpu().numpy()),
          f"CrushBaseline's {len(c_xs)} rows == FastMapper's rows on the card")
    return {"c_crush_mpps": c_mpps, "host_cpu": cpu, "pgs": len(c_xs),
            "seconds": secs, "card_crush_mpps": card_mpps,
            "card_over_c": card_mpps / c_mpps}


def ec_phase(dev, tag: str, same, check_rng) -> list[dict]:
    """The EC codec phase: (a) the corpus on the card, every recoverable
    erasure pattern decoded; (b) tools.ec_benchmark's encode and decode at
    EC_BENCH's shapes, sampled stripes against the numpy oracle; with the
    launch counts at 0 before (a) and read after (b).  Then (c) at each
    shape the gf_matvec launches of one call by graph replay, held against
    the plain version on the card, beside their bound, the codec call on
    device data, and the native C encode on the same host data.  Returns
    one row per shape."""
    import itertools

    import numpy as np
    import torch

    from ceph_tpu_torch.ec import registry_instance
    from ceph_tpu_torch.native import ec_encode_native
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import gf_kernel as gk
    from ceph_tpu_torch.tools import ec_benchmark as eb
    from ceph_tpu_torch.tools import ec_non_regression as enr

    reg = registry_instance()
    torch.cuda.synchronize()
    _build.reset_launches()
    for name, plugin, profile in enr.CONFIGS:
        codec = enr.codec_for(plugin, profile, "cuda", dev)
        before = _build.LAUNCHES["gf_matvec"]
        enc = enr.encode_all(codec)
        n, m = codec.get_chunk_count(), codec.get_coding_chunk_count()
        stored = np.load(os.path.join(enr.DEFAULT_DIR, f"{name}.npz"))
        check(all(enc[i] == stored[f"chunk_{i}"].tobytes()
                  for i in range(n)),
              f"corpus {name}: {n} chunks byte-equal to the golden corpus, "
              f"encoded on the card in "
              f"{_build.LAUNCHES['gf_matvec'] - before} gf_matvec launches")
        done, refused, wrong = 0, 0, []
        for e in range(1, m + 1):
            for lost in itertools.combinations(range(n), e):
                try:
                    dec = codec.decode(set(range(n)), {
                        i: enc[i] for i in range(n) if i not in lost})
                except IOError:
                    refused += 1
                    continue
                done += 1
                if any(dec[i] != enc[i] for i in range(n)):
                    wrong.append(lost)
        check(not wrong and done > 0
              and (refused == 0 or plugin in ("shec", "lrc")),
              f"corpus {name}: {done} erasure patterns of 1..{m} chunks "
              f"decoded on the card to the original chunks ({refused} "
              f"reported unrecoverable)")
    runs = []
    for label, plugin, profile, size, batch, workload, erasures in EC_BENCH:
        codec = reg.factory(plugin, dict(profile), dev)
        oracle = reg.factory(plugin, dict(profile, runtime="cpu"))
        if workload == "encode":
            run_ = eb.bench_encode(codec, size, EC_CALLS * batch, batch)
        else:
            run_ = eb.bench_decode(codec, size, EC_CALLS * batch, batch,
                                   erasures, False)
        sample = check_rng.choice(run_.out.shape[0], 16, replace=False)
        want = oracle.encode_chunks(run_.data[sample])
        if workload == "decode":
            want = np.concatenate([run_.data[sample], want],
                                  axis=1)[:, list(run_.lost)]
        check(np.array_equal(run_.out[sample], want),
              f"ec_benchmark {label}: 16 sampled stripes of the last call "
              f"== the numpy oracle")
        runs.append((label, codec, run_, workload, size, batch))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"launches on the EC codec path: {launches}")
    check(launches["gf_matvec"] > 0,
          f"gf_matvec launched {launches['gf_matvec']} times on the EC "
          f"codec path")

    rows = []
    for label, codec, run_, workload, size, batch in runs:
        data = torch.from_numpy(run_.data).to(dev)
        mat, src, call = _ec_operand(codec, workload, data, run_.lost)
        s, kk, b = src.shape
        t = mat.shape[0]
        groups = gk.cut_tables(mat, dev)
        check(all(len(parts) == 1 for _r0, _r1, parts in groups),
              f"{label}: every table holds all {kk} inputs")
        pidx = torch.zeros((s,), dtype=torch.int32, device=dev)
        outs = [torch.empty((s, r1 - r0, b), dtype=torch.uint8, device=dev)
                for r0, r1, _parts in groups]

        def raw():
            for (_r0, _r1, parts), o in zip(groups, outs):
                launch_gf(parts[0][2], pidx, src, o)
        raw()
        plain = gk.apply_tables(groups, src, t, gk.gf_matvec_plain)
        same("gf_matvec", torch.cat(outs, dim=1), plain,
             f"{label}: gf_matvec on ({s},{kk},{b}) x ({t},{kk}), "
             f"{len(groups)} launches == plain torch")
        got = call()
        check(torch.equal(got.reshape(plain.shape), plain),
              f"{label}: the codec's call on card data == plain torch")
        before = _build.LAUNCHES["gf_matvec"]
        call()
        per_call = _build.LAUNCHES["gf_matvec"] - before
        g_, h_ = paired_times(raw, 10)
        ms, host = statistics.median(g_), statistics.median(h_)
        call_ms = graph_ms(call, 10)
        table_bytes = sum(4 * parts[0][2].numel()
                          for _r0, _r1, parts in groups)
        b_ms, by = gf_work(s, kk, t, b, table_bytes)
        check(ms >= b_ms, f"{label}: graph replay {ms:.4f} ms at or above "
              f"its bound {b_ms:.4f} ms")
        host_src = src.cpu().numpy()
        nat = ec_encode_native(mat, host_src)
        check(np.array_equal(nat, plain.cpu().numpy()),
              f"{label}: native C encode == plain torch")
        nat_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            ec_encode_native(mat, host_src)
            nat_ms.append((time.perf_counter() - t0) * 1e3)
        nat_ms = statistics.median(nat_ms)
        host_parts = _tool_host_parts(codec, run_, workload, got)
        mib = run_.data.nbytes / 2 ** 20
        tool_mbs = run_.kib / 1024 / run_.elapsed
        row = {"label": label, "shape": f"({s},{kk},{b}) x ({t},{kk})",
               "tables": len(groups), "launches_per_call": per_call,
               "ms": ms, "host_ms": host, "bound_ms": b_ms, "bound_by": by,
               "call_ms": call_ms, "tool_mb_s": tool_mbs,
               "tool_s": run_.elapsed, "tool_kib": run_.kib,
               "native_ms": nat_ms, "native_mb_s": mib / nat_ms * 1e3,
               **host_parts}
        rows.append(row)
        print(f"{label:34s} {row['shape']:26s} gf_matvec x{len(groups)} "
              f"{ms:.4f} ms (graph replay; {host:.4f} issued)  bound "
              f"{b_ms:.4f} ms ({by})  codec call on card data {call_ms:.4f}"
              f" ms, {per_call} launches a call  {tag}")
        print(f"{label:34s} ec_benchmark {tool_mbs:.1f} MB/s ({run_.kib} "
              f"KiB in {run_.elapsed:.4f} s, {EC_CALLS} calls of {batch} "
              f"stripes, host copies included)  native C encode "
              f"{row['native_mb_s']:.1f} MB/s ({nat_ms:.3f} ms on "
              f"{mib:.0f} MiB, one core)  {tag}")
        print(f"{label:34s} a tool call, {run_.elapsed / EC_CALLS * 1e3:.3f}"
              f" ms: host gather {host_parts['gather_ms']:.3f} ms, copy to "
              f"the card {host_parts['h2d_ms']:.3f}, the call on card data "
              f"{call_ms:.3f}; the last call's copy back "
              f"{host_parts['d2h_ms']:.3f} ms  {tag}")
    return rows


def _tool_host_parts(codec, run_, workload: str, out) -> dict:
    """What an ec_benchmark call spends outside the card, by the host clock
    (median of 3): the decode's host gather of the survivors
    (``full[:n, chosen]``, 0 for an encode), the copy of the call's input
    to the card, and the copy of its output (``out``, on the card) back."""
    import numpy as np
    import torch

    data = run_.data
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    full = np.concatenate([data, data[:, :n - k]], axis=1)
    chosen = [i for i in range(n) if i not in run_.lost][:k]

    def med(fn):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)
    return {
        "gather_ms": med(lambda: full[:, chosen]) if workload == "decode"
        else 0.0,
        "h2d_ms": med(lambda: torch.from_numpy(data).to(out.device)),
        "d2h_ms": med(lambda: out.cpu())}


def run() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available")
    import numpy as np

    from ceph_tpu_torch.crush.builder import add_simple_rule, build_flat_map
    from ceph_tpu_torch.crush.fastpath import FastMapper, detect
    from ceph_tpu_torch.crush.mapper_torch import BatchMapper
    from ceph_tpu_torch.crush.mapper_ref import crush_do_rule
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE as NONE
    from ceph_tpu_torch.crush.types import (
        RULE_CHOOSE_FIRSTN, RULE_EMIT, RULE_TAKE, Rule, RuleStep)
    from ceph_tpu_torch.gf.matrix import gen_cauchy1_matrix, recovery_matrix
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import gf_kernel as gk
    from ceph_tpu_torch.ops import straw2_cuda as sc
    from ceph_tpu_torch.ops import straw2_filter as sf
    from ceph_tpu_torch.tools import crush_test, sass_report

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    print("== 1. card")
    card = card_line()
    print(card)
    print(f"torch device: {torch.cuda.get_device_name(0)}  "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    print("== 2. build")
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    print(f"built {so} from {len(_build.sources())} sources in "
          f"{time.perf_counter() - t0:.1f} s")
    try:
        sass = sass_report.report(so)
    except (OSError, subprocess.CalledProcessError) as e:
        sass = {}
        print(f"SASS and registers: not measured ({e})")
    if sass:
        print(sass_report.format_report(sass))
        for name in ("straw2_root_kernel", "straw2_froot_kernel",
                     "straw2_leaf_kernel"):
            row = sass[name]
            loop_calls = [c["kind"] for c in row["item_loop"]["calls"]]
            check("u64 divide" not in row["calls"] and not (
                set(loop_calls) - {"f32 divide slow path"}),
                f"{name}: no 64-bit divide in the kernel, no function call "
                f"per item (item loop calls: {loop_calls or 'none'})")
        for k in range(1, 9):
            row = sass.get(f"firstn_consume_kernel<{k}>", {})
            check(row.get("stack") == 0 and row.get("local") == 0,
                  f"firstn_consume_kernel<{k}>: selections in registers (no "
                  f"stack, no local memory; {row.get('registers')} registers)")

    print("== 3. main path")
    rng = np.random.default_rng(0)
    gen = gen_cauchy1_matrix(K, M)
    coding = gen[K:]
    chosen = [i for i in range(K + M) if i not in ERASURES][:K]
    rmat = recovery_matrix(gen, chosen, ERASURES)
    encode = gk.make_encoder(coding)
    recover = gk.make_encoder(rmat)
    data = torch.from_numpy(
        rng.integers(0, 256, (STRIPES, K, CHUNK), dtype=np.uint8)).to(dev)
    mats, choices = [], []
    for erased in DECODE_PATTERNS:
        ch = [i for i in range(K + M) if i not in erased][:K]
        mats.append(recovery_matrix(gen, ch, erased))
        choices.append(ch)
    tab_bits = gk.decode_bit_table(mats)
    pidx = rng.integers(0, len(mats), STRIPES)
    pidx_d = torch.from_numpy(pidx).to(dev)
    full = torch.cat([data, encode(data)], dim=1)        # (S, k+m, B)
    surv = full[:, chosen].contiguous()
    ar = torch.arange(STRIPES, device=dev)[:, None]
    dec_in = full[ar, torch.tensor(choices, device=dev)[pidx_d]].contiguous()
    dec_want = full[ar, torch.tensor(DECODE_PATTERNS, device=dev)[pidx_d]]

    crush_map, rid, reweight = bench_map()
    fm = FastMapper(detect(crush_map, rid))
    xs_np = rng.integers(0, 2 ** 32, (N_PGS,), dtype=np.uint32)
    xs = torch.from_numpy(xs_np.astype(np.int64)).to(dev)
    rw = torch.from_numpy(reweight).to(dev)
    torch.cuda.synchronize()

    _build.reset_launches()
    parity = encode(data)
    rebuilt = recover(surv)
    decoded = gk.ec_decode_batched(tab_bits, pidx, dec_in, k=K,
                                   t=len(ERASURES))
    placements = fm.run(xs, rw, NUMREP)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    schedule = dict(fm.last_schedule)
    print(f"launches on the main path: {launches}")
    print(f"crush schedule: stage 2 took {schedule['stage2_lanes']} lanes; "
          f"full re-run at R = tries + numrep: {schedule['full_rerun']}")
    for name in MAIN_KERNELS:
        check(launches[name] > 0,
              f"{name} launched {launches[name]} times on the main path")

    print("== 4. checks")
    errs = {}

    def same(name, got, want, what):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        errs[name] = max(errs.get(name, 0), err)
        check(got.shape == want.shape and err == 0, what)

    tab_enc = torch.from_numpy(gk.pack_rows(coding[None])).to(dev)
    zeros = torch.zeros((STRIPES,), dtype=torch.int32, device=dev)
    same("gf_matvec", parity, gk.gf_matvec_plain(tab_enc, zeros, data, M),
         f"encode kernel == plain torch, all {STRIPES} stripes")
    sample = rng.choice(STRIPES, 16, replace=False)
    check(np.array_equal(parity[sample].cpu().numpy(),
                         gk.ec_encode_ref(coding, data[sample].cpu().numpy())),
          "encode == numpy ec_encode_ref on 16 sampled stripes")
    tab_rec = torch.from_numpy(gk.pack_rows(rmat[None])).to(dev)
    same("gf_matvec", rebuilt,
         gk.gf_matvec_plain(tab_rec, zeros, surv, len(ERASURES)),
         "recovery kernel == plain torch")
    check(torch.equal(rebuilt, full[:, ERASURES]),
          f"recovery rebuilds erased chunks {ERASURES} exactly")
    tab_dec = torch.from_numpy(gk.pack_rows(np.stack(mats))).to(dev)
    pidx_d32 = pidx_d.to(torch.int32)
    same("gf_matvec", decoded,
         gk.gf_matvec_plain(tab_dec, pidx_d32, dec_in, len(ERASURES)),
         f"mixed decode ({len(mats)} patterns) kernel == plain torch")
    check(torch.equal(decoded, dec_want),
          "mixed decode rebuilds every stripe's erased chunks")
    check(np.array_equal(
        decoded[sample].cpu().numpy(),
        gk.ec_decode_ref(np.stack(mats), pidx[sample],
                         dec_in[sample].cpu().numpy())),
        "mixed decode == numpy ec_decode_ref on 16 sampled stripes")

    plain_place = fm.run_plain(xs, rw, NUMREP)
    same("placements", placements, plain_place,
         f"FastMapper.run through the kernels == plain torch path, "
         f"{N_PGS} PGs")
    rw_list = [int(w) for w in reweight]
    want = []
    for x in xs_np[:ORACLE_PGS]:
        p = crush_do_rule(crush_map, rid, int(x), NUMREP, rw_list)
        want.append(p + [0x7FFFFFFF] * (NUMREP - len(p)))
    check(np.array_equal(placements[:ORACLE_PGS].cpu().numpy(),
                         np.array(want)),
          f"placements == scalar crush_do_rule on {ORACLE_PGS} PGs")

    def hold_consume(hw_, lw_, x_, rw_, numrep_, tries_, what):
        # the fused kernel (is_out decided inside) against is_out in torch
        # and the same ladder: every lane, every bit
        outs = sc.consume_columns(hw_, lw_, x_, rw_, numrep=numrep_,
                                  tries=tries_)
        pouts = sc.consume_columns_plain(hw_, lw_, x_, rw_, numrep=numrep_,
                                         tries=tries_)
        for o, p, part in zip(outs, pouts, ("hosts", "devices", "overflow")):
            same("firstn_consume", o, p,
                 f"consume kernel {part} == plain, {what}")
        return outs

    cols = fm.cols
    tries = fm.fr.tries
    R1, R0 = NUMREP + 1, NUMREP + 6     # stage-1 columns; the full block
    stage1 = None
    for R in (R1, R0):
        pos, ids = cols.root_columns(xs, rw, R)
        ppos, pids = sc.root_columns_plain(xs, cols.root_ids, cols.root_w, R)
        same("straw2_root", pos, ppos, f"root kernel positions == plain, R={R}")
        same("straw2_root", ids, pids, f"root kernel ids == plain, R={R}")
        lid = cols.leaf_columns(xs, pos, R)
        plid = sc.leaf_columns_plain(xs, pos, cols.leaf_ids, cols.leaf_w,
                                     fm.fr.vary_r, R)
        same("straw2_leaf", lid, plid, f"leaf kernel == plain, R={R}")
        outs = hold_consume(ids, lid, xs, rw, NUMREP, tries,
                            f"N={N_PGS} R={R}")
        if stage1 is None:
            stage1 = (pos, ids, lid, outs[2])
    # the stage-2 launch as FastMapper.run_columns makes it: the stage-1
    # overflowing lanes first, then fillers, STAGE2_CAP of them, R0 columns
    n2 = min(FastMapper.STAGE2_CAP, N_PGS)
    need = stage1[3] != 0
    x2 = xs[torch.argsort((~need).to(torch.int8), stable=True)[:n2]]
    pos2, ids2 = cols.root_columns(x2, rw, R0)
    lid2 = cols.leaf_columns(x2, pos2, R0)
    hold_consume(ids2, lid2, x2, rw, NUMREP, tries,
                 f"the stage-2 launch, N={n2} R={R0} "
                 f"({int(need.sum())} overflowing lanes first)")
    # adversarial reweights and ids at the stage-1 columns; every unrolled
    # instance (numrep 1..8) and the generic one at the stage-2 columns
    _pos1, ids1, lid1, _ovf1 = stage1
    n_rw = rw.shape[0]
    partial_rw = torch.from_numpy(rng.integers(1, 0x10000, n_rw)).to(dev)
    adversarial = {
        "reweight all 0": torch.zeros_like(rw),
        "reweight all 0x10000": torch.full_like(rw, 0x10000),
        "reweight all 0xFFFF": torch.full_like(rw, 0xFFFF),
        "reweights above 0x10000 and negative": torch.from_numpy(rng.choice(
            [0x10001, 0x20000, 2 ** 40, -1, -0x10000, -(2 ** 40)], n_rw)
        ).to(dev),
        "random partial reweights": partial_rw,
    }
    for what, rw_ in adversarial.items():
        hold_consume(ids1, lid1, xs, rw_, NUMREP, tries, f"stage 1, {what}")
    oh0, ol0, ov0 = sc.consume_columns(ids1, lid1, xs, adversarial[
        "reweight all 0"], numrep=NUMREP, tries=tries)
    check(bool((oh0 == NONE).all()) and bool((ol0 == NONE).all())
          and bool((ov0 == 1).all()),
          "consume kernel, reweight all 0: every lane NONE and overflowing")
    odd_ids = lid1.clone()
    odd_ids[0, ::5] = -1
    odd_ids[1, 1::7] = n_rw
    odd_ids[2, 2::3] = NONE
    odd_ids[R1 - 1, ::11] = -1
    for what, rw_ in (("bench reweights", rw), ("random partial", partial_rw)):
        hold_consume(ids1, odd_ids, xs, rw_, NUMREP, tries,
                     f"stage 1, ids -1, {n_rw} and NONE, {what}")
    for nr in (1, 2, 4, 5, 6, 7, 8, 9, 12):
        hold_consume(ids2, lid2, x2, partial_rw, nr, tries,
                     f"numrep={nr}, the stage-2 columns, random partial "
                     f"reweights")

    # off the main path: the GF kernel at other widths (several passes of
    # four outputs, k off the k=8 instance, the ragged-byte path, a second
    # block of columns), a data pointer one byte off (the byte path), more
    # stripes than the grid; then the flat-rule columns
    def hold_gf(s_, k_, t_, b_, off=0):
        g_rng = np.random.default_rng(1000 * t_ + 10 * k_ + b_)
        mats_ = g_rng.integers(0, 256, (3, t_, k_), dtype=np.uint8)
        tab_ = torch.from_numpy(gk.pack_rows(mats_)).to(dev)
        raw_ = torch.from_numpy(g_rng.integers(
            0, 256, (s_ * k_ * b_ + off,), dtype=np.uint8)).to(dev)
        d_ = raw_[off:].view(s_, k_, b_)
        p_ = torch.from_numpy(g_rng.integers(0, 3, s_).astype(np.int32)
                              ).to(dev)
        same("gf_matvec", gk.gf_matvec(tab_, p_, d_, t_),
             gk.gf_matvec_plain(tab_, p_, d_, t_),
             f"kernel == plain at S={s_} k={k_} t={t_} B={b_}"
             + (f", data {off} byte off" if off else ""))

    for t_ in (1, 2, 3, 4, 5, 8):
        for k_ in (2, 4, 8, 10):
            for b_ in (1, 15, 17, 4096):
                hold_gf(5, k_, t_, b_)
    hold_gf(5, 10, 6, 100)              # two passes, ragged
    hold_gf(3, K, M, CHUNK + 16)        # a second block of columns
    hold_gf(7, K, M, CHUNK, off=1)
    hold_gf(1500, K, M, CHUNK)
    hold_gf(1500, 10, 5, 17)
    flat_map, _root, flat_rid = build_flat_map(
        300, [int(w) for w in rng.integers(0x8000, 0x20000, 300)])
    fm_flat = FastMapper(detect(flat_map, flat_rid))
    rw_flat = rw[:300]
    same("placements", fm_flat.run(xs[:4096], rw_flat, NUMREP),
         fm_flat.run_plain(xs[:4096], rw_flat, NUMREP),
         "flat choose-firstn map (300 OSDs): kernels == plain, 4096 PGs")
    # the root kernels' lane groups: the flagship root at the small
    # launches; roots of fewer items than 5 kept lower ends; edge weights.
    # The exact root here, the filter in phase 5 (after the wide path's
    # counts: its first launch builds the ln table)
    small_cases = [(cols, xs[:n_], R0, "flagship root") for n_ in SMALL_NS]
    small_cases.append((cols, xs[:37], R1, "flagship root"))
    for S_ in (1, 3, 5):
        c_ = sc.CudaColumns(synthetic_root(
            rng.integers(0x8000, 0x20000, S_) * 40, S_), dev)
        small_cases += [(c_, xs[:n_], R_, f"{S_}-item root")
                        for n_, R_ in ((1, R0), (37, R1), (4096, R0))]
    edge_w = rng.integers(0x8000, 0x20000, 64) * 40
    edge_w[[3, 10, 17, 40]] = [0, 1, 0xFFFF, 2 ** 32 - 1]
    c_ = sc.CudaColumns(synthetic_root(edge_w, 64), dev)
    small_cases += [(c_, xs[:n_], R_, "edge-weight root")
                    for n_, R_ in ((37, R1), (4096, R0), (N_PGS, R1))]
    for case in small_cases:
        hold_roots(*case, same, ("straw2_root",))
    # the leaf's lane groups: the flagship's 40-item rows at the small
    # launches; host rows with the edge weights and a row of zeros, with
    # root positions that are no host (-1, NONE) among the winners
    for n_ in SMALL_NS:
        hold_leaf(cols, xs[:n_], R0, "flagship rows", same)
    rows_w = rng.integers(0x8000, 0x20000, (16, 12))
    rows_w[3, [0, 4, 7, 11]] = [0, 1, 0xFFFF, 2 ** 32 - 1]
    rows_w[5] = 0
    rows_w[9, ::2] = 1
    rows_w[9, 1::2] = 0
    c_ = sc.CudaColumns(synthetic_leaf(rows_w, 16, vary_r=2), dev)
    for n_, R_ in ((37, R0), (4096, R0), (N_PGS, R1)):
        rp_ = c_.root_columns(xs[:n_], None, R_)[0].clone()
        rp_[0, ::7] = -1
        rp_[R_ - 1, 3::11] = NONE
        rp_[1, ::5] = 5                 # the row of zeros
        rp_[2, ::6] = 3                 # the edge weights
        rp_[2, 1::6] = 9                # weights 1 and 0
        hold_leaf(c_, xs[:n_], R_, "edge-weight rows, -1 and NONE "
                  "positions", same, root_pos=rp_)
        got_ = c_.leaf_columns(xs[:n_], rp_, R_)
        check(bool((got_[rp_ == 5] == c_.leaf_ids[5, 0]).all())
              and bool((got_[(rp_ < 0) | (rp_ == NONE)] == NONE).all()),
              f"leaf: a row of zeros gives its position 0, -1 and NONE "
              f"positions give NONE, N={n_} R={R_}")

    assert_no_faults("phases 3 and 4")

    print("== 5. wide map: crush_test on 1,000 hosts x 10 OSDs")
    wmap, wrid, wrw = bench_map(WIDE_HOSTS, WIDE_PER_HOST)
    ec_rid = add_simple_rule(wmap, -1, 1, "indep")
    flat_map, _root, flat_rid = build_flat_map(FLAT_OSDS)
    wrw_list = [int(w) for w in wrw]
    torch.cuda.synchronize()
    _build.reset_launches()
    quiet = io.StringIO()
    runs = {}
    for what, (m_, rid_, n_x, nrep, rw_) in {
            "firstn": (wmap, wrid, N_PGS, NUMREP, wrw),
            "ec_indep": (wmap, ec_rid, EC_PGS, EC_NUMREP, wrw),
            "flat": (flat_map, flat_rid, FLAT_PGS, NUMREP, None)}.items():
        st = crush_test.run_test(m_, [rid_], 0, n_x - 1, nrep, reweight=rw_,
                                 out=quiet)[rid_]
        runs[what] = st
        print(f"{what:8s} {n_x} PGs num_rep {nrep}: "
              f"{st['elapsed_s'] * 1e3:.1f} ms, "
              f"{st['mappings_per_s']:.0f} mappings/s, sizes {st['sizes']}")
    torch.cuda.synchronize()
    wide_launches = dict(_build.LAUNCHES)
    print(quiet.getvalue().rstrip())
    print(f"launches on the wide-map path: {wide_launches}")
    for name in ("straw2_froot", "ln_f32_table", "straw2_leaf",
                 "firstn_consume"):
        check(wide_launches[name] > 0,
              f"{name} launched {wide_launches[name]} times on the "
              f"wide-map path")

    def rows_array(rows, width):
        return np.array([r + [NONE] * (width - len(r)) for r in rows],
                        dtype=np.int64)

    def oracle_rows(m_, rid_, n_x, nrep, rw_list):
        # crush_test's rows drop the NONE holes of indep results
        return [[v for v in crush_do_rule(m_, rid_, x, nrep, rw_list)
                 if v != NONE] for x in range(n_x)]

    x_all = torch.arange(N_PGS, dtype=torch.int64, device=dev)
    fmw = FastMapper(detect(wmap, wrid))
    wide_place = rows_array(runs["firstn"]["rows"], NUMREP)
    check(np.array_equal(wide_place,
                         fmw.run_plain(x_all, wrw, NUMREP).cpu().numpy()),
          f"wide firstn: crush_test placements == plain torch path, "
          f"{N_PGS} PGs")
    check(runs["firstn"]["rows"][:WIDE_ORACLE]
          == oracle_rows(wmap, wrid, WIDE_ORACLE, NUMREP, wrw_list),
          f"wide firstn: placements == crush_do_rule on {WIDE_ORACLE} PGs")
    check(runs["ec_indep"]["rows"][:SMALL_ORACLE]
          == oracle_rows(wmap, ec_rid, SMALL_ORACLE, EC_NUMREP, wrw_list),
          f"EC indep: placements == crush_do_rule on {SMALL_ORACLE} PGs")
    # the interpreter is plain torch on the card: hold it against itself on
    # the CPU, positionally (NONE holes included)
    ec_x = x_all[:EC_CPU_PGS]
    ec_card = BatchMapper(wmap).do_rule(ec_rid, ec_x, EC_NUMREP, wrw)
    ec_cpu = BatchMapper(wmap, device="cpu").do_rule(
        ec_rid, ec_x.cpu(), EC_NUMREP, wrw)
    check(torch.equal(ec_card.cpu(), ec_cpu),
          f"EC indep: interpreter on the card == on the CPU, "
          f"{EC_CPU_PGS} PGs, positional")
    check([[v for v in r if v != NONE] for r in ec_card.cpu().tolist()]
          == runs["ec_indep"]["rows"][:EC_CPU_PGS],
          "EC indep: BatchMapper rows == crush_test rows")
    fm_flat_w = FastMapper(detect(flat_map, flat_rid))
    check(np.array_equal(
        rows_array(runs["flat"]["rows"], NUMREP),
        fm_flat_w.run_plain(x_all[:FLAT_PGS], [0x10000] * FLAT_OSDS,
                            NUMREP).cpu().numpy()),
        f"flat {FLAT_OSDS}: crush_test placements == plain torch path, "
        f"{FLAT_PGS} PGs")
    check(runs["flat"]["rows"][:SMALL_ORACLE]
          == oracle_rows(flat_map, flat_rid, SMALL_ORACLE, NUMREP,
                         [0x10000] * FLAT_OSDS),
          f"flat {FLAT_OSDS}: placements == crush_do_rule on "
          f"{SMALL_ORACLE} PGs")

    assert_no_faults("phase 5 (its flat rule rides the dispatch engine)")

    wcols = fmw.cols
    table = sf.ln_f32_table(dev)
    D = sf.ln_f32_bound(dev)
    print(f"f32 ln bound D = {D!r} (S_root padded {wcols.S_root})")
    # the table kernel reduces D itself: a fresh launch, its D against the
    # torch reduction over the very table it wrote, and the card's value
    ln_out = torch.empty((65536,), dtype=torch.float32, device=dev)
    d_bits = torch.empty((1,), dtype=torch.int32, device=dev)
    launch_ln(wcols.ln_tab, ln_out, d_bits)
    d_kernel = float(d_bits.view(torch.float32)[0])
    d_torch = float(sf.ln_bound_plain(ln_out))
    check(d_kernel == d_torch,
          f"ln_f32_table kernel's D {d_kernel!r} == torch reduction over its "
          f"table {d_torch!r}")
    check(d_kernel == D == LN_BOUND_D and torch.equal(ln_out, table),
          f"ln_f32_table: D == {LN_BOUND_D:.0f}, as ln_f32_bound and every "
          f"run so far; the table as the cached one")
    plain_table, plain_D = sf.ln_f32_table_plain(dev)
    ln_err = float((table - plain_table).abs().max())
    errs["ln_f32_table"] = ln_err
    check(ln_err <= LN_TOL,
          f"ln_f32_table kernel == torch.log2 on the card within "
          f"{LN_TOL:g} (max abs err {ln_err:g}; the plain version's own D "
          f"{float(plain_D):.0f})")
    # the consume kernel on the wide map's firstn columns (through the
    # filter root) and the flat map's
    wrw_t = torch.from_numpy(wrw).to(dev)
    wpos1, wids1, _wovf = wcols.froot_columns(x_all, wrw_t, R1)
    wlid1 = wcols.leaf_columns(x_all, wpos1, R1)
    hold_consume(wids1, wlid1, x_all, wrw_t, NUMREP, fmw.fr.tries,
                 f"wide firstn, N={N_PGS} R={R1}")
    fids = fm_flat_w.cols.root_columns(x_all[:FLAT_PGS], None, R0)[1]
    flat_rw = torch.full((FLAT_OSDS,), 0x10000, dtype=torch.int64,
                         device=dev)
    for what, rw_ in (("reweights 0x10000", flat_rw),
                      ("random partial reweights", torch.from_numpy(
                          rng.integers(0, 0x10001, FLAT_OSDS)).to(dev))):
        hold_consume(fids, fids, x_all[:FLAT_PGS], rw_, NUMREP,
                     fm_flat_w.fr.tries,
                     f"flat {FLAT_OSDS}, N={FLAT_PGS} R={R0}, {what}")
    for R in (R1, R0):
        fpos, fids, fovf = wcols.froot_columns(x_all, wrw, R)
        ppos, pids, povf = sf.froot_columns_plain(
            x_all, wcols.root_ids, wcols.root_w, R, table, D)
        same("straw2_froot", fpos, ppos, f"filter kernel positions == "
             f"plain, R={R}")
        same("straw2_froot", fids, pids, f"filter kernel ids == plain, R={R}")
        same("straw2_froot", fovf, povf, f"filter kernel flags == plain, "
             f"R={R} ({int(fovf.sum())} flagged)")
        epos, eids = sc.root_columns_plain(x_all, wcols.root_ids,
                                           wcols.root_w, R)
        clean = fovf == 0
        check(torch.equal(fpos[:, clean], epos[:, clean])
              and torch.equal(fids[:, clean], eids[:, clean]),
              f"filter kernel == exact root columns where the flag is 0, "
              f"R={R}")
    both = ("straw2_root", "straw2_froot")
    for case in small_cases:
        hold_roots(*case, same, ("straw2_froot",))
    for n_ in SMALL_NS:
        hold_roots(wcols, x_all[:n_], R0, "wide root", same, both)
        hold_leaf(wcols, x_all[:n_], R0, "wide rows", same)
    hold_roots(fm_flat_w.cols, x_all[:FLAT_PGS], R0, "flat 1,024 root", same,
               both)
    skew_w = rng.integers(0x8000, 0x20000, 1024) * 10
    skew_w[rng.choice(1024, 20, replace=False)] = 0
    c_ = sc.CudaColumns(synthetic_root(skew_w, 1024), dev)
    for n_, R_ in ((37, R0), (4096, R0), (N_PGS, R1)):
        hold_roots(c_, x_all[:n_], R_, "skewed 1,024 root", same, both)
    huge = 1e30
    hpos = torch.empty((R1, N_PGS), dtype=torch.int32, device=dev)
    hids = torch.empty_like(hpos)
    hovf = torch.zeros((N_PGS,), dtype=torch.int32, device=dev)
    wx32 = sc.xs_i32(x_all).contiguous()
    launch_froot(wcols, wx32, N_PGS, R1, 1, huge, table, hpos, hids, hovf)
    _hp, _hi, hovf_plain = sf.froot_columns_plain(
        x_all, wcols.root_ids, wcols.root_w, R1, table, huge)
    check(bool((hovf == 1).all()) and torch.equal(hovf, hovf_plain),
          f"D = {huge:g}: the kernel flags every x, as the plain version")
    real_bound = sf.ln_f32_bound
    sf.ln_f32_bound = lambda device: huge
    try:
        fallback = fmw.run(x_all, wrw, NUMREP)
        sched = dict(fmw.last_schedule)
    finally:
        sf.ln_f32_bound = real_bound
    check(sched["froot_fallback"] and np.array_equal(
        fallback.cpu().numpy(), wide_place),
          f"D = {huge:g}: FastMapper falls back to the exact root and "
          f"still matches ({sched})")

    print("== 6. times")
    tag = f"[{card}]"
    data_bytes = STRIPES * K * CHUNK
    t_enc = time_ms(lambda: encode(data), 10)
    t_rec = time_ms(lambda: recover(surv), 10)
    t_crush = time_ms(lambda: fm.run(xs, rw, NUMREP), 3)
    print(f"EC encode  {data_bytes / t_enc / 1e3:.1f} MB/s "
          f"({t_enc:.4f} ms per {data_bytes >> 20} MiB call) {tag}")
    print(f"EC recover {data_bytes / t_rec / 1e3:.1f} MB/s "
          f"({t_rec:.4f} ms per {data_bytes >> 20} MiB call) {tag}")
    print(f"CRUSH      {N_PGS / t_crush / 1e3:.4f} Mpps "
          f"({t_crush:.4f} ms per {N_PGS}-PG call) {tag}")
    crush_baseline = c_crush_row(crush_map, rid, reweight, xs_np,
                                 placements, N_PGS / t_crush / 1e3, tag)
    # where the flagship CRUSH call's time goes: the card's busy share
    prof = profile_window(lambda: fm.run(xs, rw, NUMREP))
    if prof["busy_ms"] > 0 and prof["device_ms"] > 0:
        calls = prof["calls"]
        print(f"CRUSH call under torch.profiler ({calls} calls): window "
              f"{prof['window_ms'] / calls:.4f} ms a call, device busy "
              f"{prof['busy_ms'] / calls:.4f} ms a call (key_averages: "
              f"{prof['device_ms'] / calls:.4f}), busy share "
              f"{prof['busy_share']:.4f}, idle share "
              f"{1 - prof['busy_share']:.4f}; the profiler slows the host, "
              f"so beside the call's own {t_crush:.4f} ms the busy time is a "
              f"share of {prof['busy_ms'] / calls / t_crush:.4f}  {tag}")
        for name, ms in prof["top"]:
            print(f"  {ms / calls:.4f} ms a call  {name[:100]}")
    else:
        print("CRUSH call under torch.profiler: device busy share not "
              "measured (the trace holds no device time)")
    # the call's host time in this process: its spread over more reps, the
    # same with the garbage collector off, and the host's state
    crush_on = sorted(host_times(lambda: fm.run(xs, rw, NUMREP), 3, 31))
    gc.disable()
    try:
        crush_off = sorted(host_times(lambda: fm.run(xs, rw, NUMREP), 3, 31))
    finally:
        gc.enable()
    print(f"CRUSH call, 31 reps of 3: min {crush_on[0]:.4f} median "
          f"{crush_on[15]:.4f} max {crush_on[-1]:.4f} ms; gc off: min "
          f"{crush_off[0]:.4f} median {crush_off[15]:.4f} max "
          f"{crush_off[-1]:.4f} ms; {len(gc.get_objects())} objects tracked "
          f"by gc; load average {' '.join(f'{v:.2f}' for v in os.getloadavg())}"
          f" on {len(os.sched_getaffinity(0))} cores  {tag}")

    # each kernel at its main-path shape: the EC encode, and the stage-1
    # columns (R = numrep + 1) over every PG.  Kernel times are raw launches
    # of prepared operands, by graph replay (ms) and issued one by one
    # (host_ms); plain times are the plain torch versions.
    x32 = sc.xs_i32(xs).contiguous()
    pos1 = stage1[0]
    H, S_leaf = cols.leaf_ids.shape
    S_root = cols.root_ids.shape[0]
    enc_out = torch.empty((STRIPES, M, CHUNK), dtype=torch.uint8, device=dev)
    col_a = torch.empty((R1, N_PGS), dtype=torch.int32, device=dev)
    col_b = torch.empty_like(col_a)
    rep_a = torch.empty((NUMREP, N_PGS), dtype=torch.int32, device=dev)
    rep_b = torch.empty_like(rep_a)
    ovf = torch.empty((N_PGS,), dtype=torch.int32, device=dev)
    S_wide = wcols.root_ids.shape[0]
    g_root = sc.card_group_lanes(N_PGS * R1, S_root, dev)
    g_leaf = sc.card_group_lanes(N_PGS * R1, S_leaf, dev)
    g_froot = sc.card_group_lanes(N_PGS * R1, S_wide, dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads1 = sc.consume_threads(N_PGS, sms)

    raw = {
        "gf_matvec": lambda: launch_gf(tab_enc, zeros, data, enc_out),
        "straw2_root": lambda: launch_root(cols, x32, N_PGS, R1, g_root,
                                           col_a, col_b),
        "straw2_leaf": lambda: launch_leaf(cols, x32, N_PGS, R1, g_leaf, pos1,
                                           col_a),
        "firstn_consume": lambda: launch_consume(
            ids1, lid1, x32, rw, NUMREP, tries, threads1, rep_a, rep_b, ovf),
        # the wide map's stage-1 columns: every PG of crush_test, R1
        "straw2_froot": lambda: launch_froot(wcols, wx32, N_PGS, R1, g_froot,
                                             D, table, col_a, col_b, ovf),
        "ln_f32_table": lambda: launch_ln(wcols.ln_tab, ln_out, d_bits),
    }
    plain = {
        "gf_matvec": lambda: gk.gf_matvec_plain(tab_enc, zeros, data, M),
        "straw2_root": lambda: sc.root_columns_plain(
            xs, cols.root_ids, cols.root_w, R1),
        "straw2_leaf": lambda: sc.leaf_columns_plain(
            xs, pos1, cols.leaf_ids, cols.leaf_w, fm.fr.vary_r, R1),
        "firstn_consume": lambda: sc.consume_columns_plain(
            ids1, lid1, xs, rw, numrep=NUMREP, tries=tries),
        "straw2_froot": lambda: sf.froot_columns_plain(
            x_all, wcols.root_ids, wcols.root_w, R1, table, D),
        "ln_f32_table": lambda: sf.ln_f32_table_plain(dev),
    }
    root_nz = int((cols.root_w > 0).sum())
    leaf_nz = (cols.leaf_w > 0).sum(dim=1)
    work1 = ladder_work(ids1, lid1, xs, rw, NUMREP, tries)
    print(f"consume ladder, stage 1: {work1}")
    wide_nz = int((wcols.root_w > 0).sum())
    # the straw2 kernels' root positions at the stage-2 launch
    # (STAGE2_CAP lanes), at the run's overflowing lanes alone, and at
    # stage 1; and the items each launch draws (non-zero weights only; the
    # leaf only the winning host's row)
    n_lanes = max(1, min(schedule["stage2_lanes"], n2))
    leaf_pos = {(N_PGS, R1): pos1}
    for n_ in (n2, n_lanes):
        leaf_pos[n_, R0] = cols.root_columns(xs[:n_], None, R0)[0]
    items = {
        "straw2_root": lambda n_, R_: R_ * n_ * root_nz,
        "straw2_leaf": lambda n_, R_: int(
            leaf_nz[leaf_pos[n_, R_].long()].sum()),
        "straw2_froot": lambda n_, R_: R_ * n_ * wide_nz,
    }

    def gf_bound(t_, tab_):
        return gf_work(STRIPES, K, t_, CHUNK, 4 * tab_.numel())

    work = {
        "gf_matvec": gf_bound(M, tab_enc),
        "straw2_root": bound(
            4 * N_PGS + 12 * S_root + 8 * 514 + 8 * R1 * N_PGS,
            items["straw2_root"](N_PGS, R1) * OPS_PER_DRAW),
        "straw2_leaf": bound(
            4 * N_PGS + 4 * R1 * N_PGS + 16 * H * S_leaf + 8 * 514
            + 4 * R1 * N_PGS, items["straw2_leaf"](N_PGS, R1) * OPS_PER_DRAW),
        "firstn_consume": consume_bound(work1, N_PGS, NUMREP),
        "straw2_froot": bound(
            4 * N_PGS + 16 * S_wide + 8 * 514 + 8 * R1 * N_PGS + 4 * N_PGS,
            R1 * N_PGS * (wide_nz * FILTER_OPS_PER_ITEM
                          + sf.K * OPS_PER_DRAW)),
        # the ln tables read, the f32 table and D written
        "ln_f32_table": bound(8 * 514 + 4 * 65536 + 4, 65536 * LN_OPS),
    }
    # the integer-pipe floor of the straw2 kernels: ALU instructions per
    # item (phase 2's SASS) x items / (64 lanes x SMs x clock)
    clock = sm_clock_hz()

    def int_floor_ms(name, n_, R_):
        loop = (sass.get(f"{name}_kernel") or {}).get("item_loop")
        if not loop or not clock:
            return None
        return (loop["per_item"].get("alu", 0) * items[name](n_, R_)
                / (INT_LANES_PER_SM * sms * clock) * 1e3)

    def both(fn, iters=20):
        """(graph-replay ms, host-launched ms, the two lists of reps)"""
        g_, h_ = paired_times(fn, iters)
        return statistics.median(g_), statistics.median(h_), g_, h_

    shapes = {
        "gf_matvec": f"({STRIPES},{K},{CHUNK}) -> ({STRIPES},{M},{CHUNK})",
        "straw2_root": f"N={N_PGS} R={R1} S={S_root} G={g_root}",
        "straw2_leaf": f"N={N_PGS} R={R1} H={H} S={S_leaf} G={g_leaf}",
        "firstn_consume": f"N={N_PGS} R={R1} numrep={NUMREP} T={threads1}",
        "straw2_froot": f"N={N_PGS} R={R1} S={S_wide} G={g_froot}",
        "ln_f32_table": "65536 -> 65536 f32 and D",
    }
    meta = {
        "gf_matvec": ("ceph_tpu_torch/csrc/gf_matvec.cu",
                      "ceph_tpu/ops/gf_kernel.py:283"),
        "straw2_root": ("ceph_tpu_torch/csrc/straw2.cu",
                        "ceph_tpu/ops/pallas_straw2.py:237"),
        "straw2_leaf": ("ceph_tpu_torch/csrc/straw2.cu",
                        "ceph_tpu/ops/pallas_straw2.py:268"),
        "firstn_consume": ("ceph_tpu_torch/csrc/straw2.cu",
                           "ceph_tpu/ops/pallas_straw2.py:583"),
        "straw2_froot": ("ceph_tpu_torch/csrc/straw2_filter.cu",
                         "ceph_tpu/ops/pallas_straw2.py:514"),
        "ln_f32_table": ("ceph_tpu_torch/csrc/straw2_filter.cu",
                         "ceph_tpu/ops/pallas_straw2.py:339"),
    }
    # each kernel's launches on its own path: the flagship main path, or
    # the wide-map crush_test path for the filter and its table
    path_launches = dict(launches, straw2_froot=wide_launches["straw2_froot"],
                         ln_f32_table=wide_launches["ln_f32_table"])
    tolerance = {"ln_f32_table": LN_TOL}
    kernels = []
    for name in raw:
        ms, host, g_reps, h_reps = both(raw[name])
        plain_ms = time_ms(plain[name], 1, reps=5)
        bound_ms, bound_by = work[name]
        print(f"{name:15s} {shapes[name]:34s} kernel {ms:.4f} ms (graph "
              f"replay; {host:.4f} issued from Python)  plain "
              f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  "
              f"launches/step {path_launches[name]}  {tag}")
        src, replaces = meta[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": path_launches[name],
            "max_abs_err": errs[name],
            "matches_plain": errs[name] <= tolerance.get(name, 0),
            "ms": ms, "host_ms": host, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        # a graph that replayed less than the work would read below the
        # least time the card can take for it
        check(ms >= bound_ms, f"{name}: graph replay {ms:.4f} ms at or above "
              f"its bound {bound_ms:.4f} ms")
        if name == "gf_matvec":
            # a kernel longer than the host's cost per launch: the two ways
            # of timing it differ by about the gap between two launches on
            # the card, which a graph shortens
            print(f"gf_matvec       encode: issued - graph replay = "
                  f"{(host - ms) * 1e3:.2f} us ({(host - ms) / host:.1%}); "
                  f"reps: graph {min(g_reps):.4f}-{max(g_reps):.4f}, issued "
                  f"{min(h_reps):.4f}-{max(h_reps):.4f} ms  {tag}")
        if name in items:
            floor = int_floor_ms(name, N_PGS, R1)
            kernels[-1]["int_floor_ms"] = floor
            print(f"{name:15s} integer-pipe floor "
                  + (f"{floor:.4f} ms" if floor is not None
                     else "not measured") + f"  {tag}")
    row_of = {k["name"]: k for k in kernels}
    # GF at the path's other two products: recovery (t = 2) and the mixed
    # decode (three patterns, t = 2)
    for what, tab_, p_, src_ in (("recover", tab_rec, zeros, surv),
                                 ("decode", tab_dec, pidx_d32, dec_in)):
        out_ = torch.empty((STRIPES, len(ERASURES), CHUNK), dtype=torch.uint8,
                           device=dev)
        ms, host, _g, _h = both(lambda: launch_gf(tab_, p_, src_, out_))
        b_ms, _by = gf_bound(len(ERASURES), tab_)
        print(f"gf_matvec       {what:8s} ({STRIPES},{K},{CHUNK}) -> "
              f"({STRIPES},{len(ERASURES)},{CHUNK}) kernel {ms:.4f} ms (graph "
              f"replay; {host:.4f} issued)  bound {b_ms:.4f} ms  {tag}")
        row_of["gf_matvec"].update({f"{what}_ms": ms, f"{what}_host_ms": host,
                                    f"{what}_bound_ms": b_ms})
    # the encode on all-zero data: every lookup of a warp reads one word (a
    # broadcast), so the gap to the random-data time is what the random
    # lookups' shared-memory bank conflicts cost
    zero_data = torch.zeros_like(data)
    ms = graph_ms(lambda: launch_gf(tab_enc, zeros, zero_data, enc_out), 20)
    print(f"gf_matvec       encode on zero data (no bank conflicts) kernel "
          f"{ms:.4f} ms (graph replay)  {tag}")
    row_of["gf_matvec"]["encode_zero_data_ms"] = ms
    # the exact root kernel on the filter's columns: which is faster here
    root_wide = graph_ms(lambda: launch_root(wcols, wx32, N_PGS, R1, g_froot,
                                             col_a, col_b), 20)
    froot_ms = row_of["straw2_froot"]["ms"]
    print(f"straw2_root     N={N_PGS} R={R1} S={S_wide} G={g_froot} (the "
          f"filter's columns) kernel {root_wide:.4f} ms; straw2_froot / "
          f"straw2_root = {froot_ms / root_wide:.3f}  {tag}")

    # the straw2 kernels at the stage-2 launch (STAGE2_CAP lanes, the run's
    # overflowing lanes first, over the full block of R0 columns) and at
    # the overflowing lanes alone; then every lane group at the stage-2
    # launch and at stage 1
    col_c = torch.empty((R0, n2), dtype=torch.int32, device=dev)
    col_d = torch.empty_like(col_c)
    straw2 = {   # kernel: (launch at (n, R, G) into out, S, operations per
                 #          item, stage-1 G)
        "straw2_root": (lambda n_, R_, G, out: launch_root(
            cols, x32, n_, R_, G, *out), S_root, OPS_PER_DRAW, g_root),
        "straw2_leaf": (lambda n_, R_, G, out: launch_leaf(
            cols, x32, n_, R_, G, leaf_pos[n_, R_], out[0]), S_leaf,
            OPS_PER_DRAW, g_leaf),
        "straw2_froot": (lambda n_, R_, G, out: launch_froot(
            wcols, wx32, n_, R_, G, D, table, *out, ovf), S_wide,
            FILTER_OPS_PER_ITEM, g_froot),
    }
    for name, (fn, S_, per_item, g1) in straw2.items():
        row = row_of[name]
        for n_ in sorted({n2, n_lanes}, reverse=True):
            G = sc.card_group_lanes(n_ * R0, S_, dev)
            ms, host, _g, _h = both(lambda: fn(n_, R0, G, (col_c, col_d)))
            b_ms, _by = bound(8 * R0 * n_, items[name](n_, R0) * per_item)
            print(f"{name:15s} stage 2 N={n_} R={R0} S={S_} G={G}  kernel "
                  f"{ms:.4f} ms (graph replay; {host:.4f} issued)  bound "
                  f"{b_ms:.4f} ms  {tag}")
            if n_ == n2:
                row.update(G=g1, stage2_shape=f"N={n_} R={R0}", stage2_G=G,
                           stage2_ms=ms, stage2_host_ms=host,
                           stage2_bound_ms=b_ms,
                           stage2_int_floor_ms=int_floor_ms(name, n_, R0))
        for n_, R_, gs, out in ((n2, R0, (1, 2, 4, 8, 16, 32), (col_c, col_d)),
                                (N_PGS, R1, (1, 2, 4), (col_a, col_b))):
            sweep = {G: graph_ms(lambda: fn(n_, R_, G, out), 10) for G in gs}
            print(f"{name:15s} N={n_} R={R_} by G (graph replay): "
                  + "  ".join(f"G={G} {ms:.4f} ms" for G, ms in sweep.items())
                  + f"  {tag}")
    # the consume kernel at the stage-2 launch (the run's overflowing lanes
    # first, R0 columns), and over its block sizes there and at stage 1
    x2_32 = sc.xs_i32(x2).contiguous()
    rep_c = torch.empty((NUMREP, n2), dtype=torch.int32, device=dev)
    rep_d = torch.empty_like(rep_c)
    ovf2 = torch.empty((n2,), dtype=torch.int32, device=dev)
    threads2 = sc.consume_threads(n2, sms)
    work2 = ladder_work(ids2, lid2, x2, rw, NUMREP, tries)
    b_ms, _by = consume_bound(work2, n2, NUMREP)
    consume_at = {
        (n2, R0): lambda th: launch_consume(ids2, lid2, x2_32, rw, NUMREP,
                                            tries, th, rep_c, rep_d, ovf2),
        (N_PGS, R1): lambda th: launch_consume(ids1, lid1, x32, rw, NUMREP,
                                               tries, th, rep_a, rep_b, ovf),
    }
    ms, host, _g, _h = both(lambda: consume_at[n2, R0](threads2))
    print(f"firstn_consume  stage 2 N={n2} R={R0} T={threads2} {work2}  "
          f"kernel {ms:.4f} ms (graph replay; {host:.4f} issued)  bound "
          f"{b_ms:.4f} ms  {tag}")
    row_of["firstn_consume"].update(
        threads=threads1, stage2_shape=f"N={n2} R={R0}",
        stage2_threads=threads2, stage2_ms=ms, stage2_host_ms=host,
        stage2_bound_ms=b_ms)
    for (n_, R_), fn in consume_at.items():
        sweep = {th: graph_ms(lambda: fn(th), 20) for th in (32, 64, 128, 256)}
        print(f"firstn_consume  N={n_} R={R_} by threads a block (graph "
              f"replay): " + "  ".join(f"T={th} {ms:.4f} ms"
                                       for th, ms in sweep.items())
              + f"  {tag}")
    assert_no_faults("phase 6")
    print("== 7. EC codecs; a fast-path rule of 65 replicas")
    # GF at the EC codec path's shapes, in gf_matvec's row
    row_of["gf_matvec"]["ec_shapes"] = ec_phase(dev, tag, same, rng)
    # numrep 65, past the consume kernel's unrolled instances: driven
    # through BatchMapper with the counts at 0, it launches the consume
    # kernel (the generic instance) and agrees with crush_do_rule; the
    # kernel is held against its plain version on that rule's own columns
    nmap, _nroot, _nrid = build_flat_map(WIDE_NUMREP_OSDS)
    nrid = nmap.add_rule(Rule(
        ruleset=nmap.max_rules, type=1, min_size=1, max_size=WIDE_NUMREP,
        steps=[RuleStep(RULE_TAKE, -1, 0),
               RuleStep(RULE_CHOOSE_FIRSTN, WIDE_NUMREP, 0),
               RuleStep(RULE_EMIT, 0, 0)]))
    nrw = np.full(WIDE_NUMREP_OSDS, 0x10000, dtype=np.int64)
    nrw[rng.choice(WIDE_NUMREP_OSDS, 8, replace=False)] = 0
    nrw[rng.choice(WIDE_NUMREP_OSDS, 8, replace=False)] = 0x8000
    nxs_np = xs_np[:WIDE_NUMREP_PGS]
    _build.reset_launches()
    wide_rows = BatchMapper(nmap).do_rule(nrid, nxs_np, WIDE_NUMREP, nrw)
    torch.cuda.synchronize()
    numrep_launches = dict(_build.LAUNCHES)
    print(f"choose firstn {WIDE_NUMREP}: launches {numrep_launches}")
    check(wide_rows.is_cuda and numrep_launches["firstn_consume"] >= 1
          and numrep_launches["straw2_root"]
          + numrep_launches["straw2_froot"] >= 1,
          f"choose firstn {WIDE_NUMREP} runs on the card through the root "
          f"and consume kernels")
    check(np.array_equal(wide_rows.cpu().numpy(), rows_array(
        [crush_do_rule(nmap, nrid, int(x), WIDE_NUMREP,
                       [int(v) for v in nrw])
         for x in nxs_np], WIDE_NUMREP)),
          f"choose firstn {WIDE_NUMREP} on {WIDE_NUMREP_OSDS} OSDs == "
          f"crush_do_rule on {WIDE_NUMREP_PGS} PGs")
    fm_n = FastMapper(detect(nmap, nrid))
    nxs = torch.from_numpy(nxs_np.astype(np.int64)).to(dev)
    nrw_t = torch.from_numpy(nrw).to(dev)
    for R_ in (WIDE_NUMREP + 1, fm_n.fr.tries + WIDE_NUMREP):
        _pos_n, ids_n = fm_n.cols.root_columns(nxs, nrw_t, R_)
        hold_consume(ids_n, ids_n, nxs, nrw_t, WIDE_NUMREP, fm_n.fr.tries,
                     f"numrep={WIDE_NUMREP} (the generic instance), "
                     f"N={WIDE_NUMREP_PGS} R={R_}")

    assert_no_faults("phase 7")

    print("== 8. the dispatch engine: EC writes, degraded reads, remaps")
    engine = engine_phase(dev, tag, xs_np)

    print("== 9. the OSDMap and the shared PG mapping service")
    mapping, ladder_rows, mapped = mapping_phase(dev, tag)
    kernels.extend(ladder_rows)

    print("== 10. the OSD data path on a MiniCluster")
    cluster, gf_cluster, (scrub, scrub_row) = cluster_phase(dev, tag)
    row_of["gf_matvec"]["cluster"] = gf_cluster
    kernels.append(scrub_row)

    print("== 12. BlueStore on the card")
    bluestore, pack_row, bs_digest = bluestore_phase(dev, tag)
    scrub_row["bluestore_data_launches"] = bs_digest
    kernels.append(pack_row)

    print("== 13. the manager: MgrDaemon on a MiniCluster, the balancer")
    mgr, mgr_launches = mgr_phase(dev, tag, mapped)
    ladder_rows[0]["manager_launches"] = mgr_launches
    ladder_rows[0]["what_if"] = {
        pid: row.get("kernel") for pid, row in
        mgr["balancer"]["pools"].items()}

    print("== 14. the daemons over TCP with cephx, and as processes")
    tcp, tcp_launches = tcp_phase(dev, tag, cluster)
    row_of["gf_matvec"]["tcp"] = {s: n["gf_matvec"]
                                  for s, n in tcp_launches.items()}
    scrub_row["tcp_bluestore_data_launches"] = {
        s: n["scrub_digest"] for s, n in tcp_launches.items()}

    print("== 15. results")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"crush_baseline": crush_baseline}))
    print(json.dumps({"engine": engine}))
    print(json.dumps({"mapping": mapping}))
    print(json.dumps({"cluster": cluster}))
    print(json.dumps({"scrub": scrub}))
    print(json.dumps({"bluestore": bluestore}))
    print(json.dumps({"mgr": mgr}))
    print(json.dumps({"tcp": tcp}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        run()
    except Exception:       # any failed phase: report it, print no result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
