"""Smoke test of the PyTorch/CUDA port (imsame_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # the smoke test
    python3 chip_smoke.py --ab PARENT [DIR]    # kernel A/B, see phase_ab
    python3 chip_smoke.py --ab-traceback CHECKOUT...  # the traceback's
    python3 chip_smoke.py --config3            # config-3, 1M x 1M reads
    python3 chip_smoke.py --config3 --gate-enum  # and with enumeration

Phases, in order but for 9, which runs right after 6 (it reuses 4-6's
engines, then frees them before 7), and 10, which runs after 8 (it reuses
4-5's and 8's samples), before 11; any failure raises and exits non-zero:

  1. device  -- requires torch.cuda; prints the card's name and power limit
                (nvidia-smi), its SMs and max SM clock, and the torch /
                CUDA versions.
  2. build   -- compiles the native host runtime (gcc) and the four
                kernels, nw_stats, nw_forward, traceback and gate (nvcc,
                sm_90a, one process per source) from this checkout; prints
                each build's seconds and the ptxas register report.
  3. kernels -- nw_stats, nw_forward, traceback and gate against their
                plain torch versions on the same CUDA tensors
                (kernel_cases, gate_cases; the traceback walks the
                nw_forward kernel's outputs); every output must be exactly
                equal (integer DP; the gate's pass and exact words bit for
                bit).  The gate (check_gate) on the 20k workload's rows
                and on 2,000 long reads a side, real and random
                candidates, every candidate format and both index
                payloads: full chunks of 2^21 at the windows 256 and 64
                and 87,360 at 3072 (some with padding slots), and 128,
                512, 1024 and 2048 once each; timed with L2 flushed before
                each launch, with its bytes bound (gate_bound), its bases
                walked a second and its lane efficiency.  The
                traceback at the render ladder's batches of every bucket
                (2048 at 128 and 256, 1024, 256, 64 and 8, 24 and 8),
                at 3072 / 272 (past 2^31 bp words: 64-bit offsets), on the
                degenerate pairs, on the tie pairs at 256-3072 and on
                render-like pairs (a read and its copy with 4 %
                substitutions): 24 of 2,500-3,000 bp with 1 % indels at
                3072, 2048 of 250 bp at 256, printing
                max(n_steps), the microseconds a move, the band's rounds
                (tile_rounds) and the microseconds a round
                (check_traceback).  For the NW kernels: pairs with empty
                and 1-base reads, and pairs longer than the bucket (a
                batch's padding pairs repeat read 0, which may be), at L
                = 128 and 256 and appended to every long bucket's batch;
                tie-heavy pairs (tie_pairs) at 256 and 512, and for
                nw_forward at 1024 and 3072 (4 and 12 strips handing
                off); the short path's shapes
                at L = 256 (mixed pairs, lengths 2..256); every long bucket
                at the batches the compare and render paths use (lengths
                0.6L..L): nw_stats at B = 256 and, at 512/1024, 2048;
                nw_forward at the render ladder's top batch (1024, 256, 64,
                24) and its 8-pair tail; past the pairs resident on the
                card (2 x nw_cuda.resident_pairs + 8 pairs of 0.05L..L:
                nw_stats at 2048 and 3072, where each warp loops over
                pairs, and nw_forward at 512 and 3072, where blocks run in
                waves; nw_forward at 3072 held on a slice of 32 pairs); the
                long 20k compare's largest launch (nw_stats at 3072, B =
                32,768, held on a slice of 2 x resident + 8 pairs); and the
                test shapes of the Pallas functions off
                the path (tests/test_nw_pallas.py, tests/test_nw_stats.py,
                tests/test_longreads.py).  Times the kernel and the plain
                version with CUDA events and prints real cells/s and the
                share of the bound (see bound); past L = 256 the plain
                version runs once per (function, bucket), on the batch and
                its 8 appended pairs, and the kernel is timed on the batch
                alone (and on a smaller slice of it).  Prints each
                kernel's resident pairs per bucket.
  4. slice   -- TorchEngine(db, Config(), device="cuda").compare(q) and
                render_report on the 20k x 20k, 250 bp bench workload
                (bench.py synth_pair(20000, 250, 0.5, seed=12345)): must
                accept 10,005 reads with both kernels launched; then the
                first 2,000 query reads against the same database, whose
                report must hash to the JAX engine's (REF_2K_SHA256).
  5. long    -- bench.py longread_bench's 512 reads of 300..3000 bp
                (random.Random(4242); tests/util_synth.py): compare and
                render must accept 256 reads with a report that hashes to
                the JAX engine's (REF_LONG_SHA256), and nw_forward must run
                a 24-pair chunk at L = 3072; prints the kernels' batch
                shapes per bucket.
  6. long20k -- 20,000 query reads of 300..3000 bp against 20,000 db reads,
                half of them copies of query reads with 4% substitutions
                and 1% indels (numpy, seed 2024): compare and render; must
                accept 10,000 reads, each with its own copy, and render
                10,000 records; prints the kernels' batch shapes per
                bucket, the render's wall, report bytes and sha256 and
                peak device memory.  A second (warm, traced) render and a
                third, whose first chunk of each bucket the plain
                traceback also walks (its chains must equal the kernel's),
                must give the same report.
  7. sweep   -- the all-vs-all sweep of bench.py sweep_bench's four
                samples of 20,000 reads of 250 bp (write_sweep_samples):
                AllVsAllRunner(out, Config(), device="cuda").run must
                finish its 12 jobs (6 sample pairs, forward and revcomp)
                with no failure; prints the wall, sample pairs/hour, each
                job's accepted count and seconds and the kernels'
                launches.  Then: each job again through a serial
                TorchEngine compare + render_report (db through
                revcomp_fasta_bytes for .r jobs), whose report must equal
                the sweep's file byte for byte (prints each job's serial
                compare and render walls); a second runner on the same
                outdir must build no engine and return the same stats;
                the same sweep of 2,000-read samples must give the JAX
                sweep's 12 accepted counts and report hashes
                (REF_SWEEP_2K); so must a sweep of small samples holding
                reverse-complemented copies, whose .r jobs accept reads
                (write_rc_samples, REF_SWEEP_RC); and so must two processes
                of the orchestrator with --distributed on the 2,000-read
                samples (gloo on localhost, one card), which must print
                the same total.  A traced pass of the 20k sweep must also
                finish its 12 jobs with no failure.
  8. wide    -- config-3's workload (bench_config3.py synth, seed 99, 250 bp
                reads, 90 % of the db reads 2 %-mutated query copies;
                synth_config3) at N_WIDE = 2^20 + 2^15 reads a side, past
                the packed formats' 2^20 reads, Config(first_window=32,
                first_window_auto=False) (WIDE_CONFIG): (a) the whole db
                side as the database, which takes the wide (pos, sid,
                db_start) index (~258 M entries): compare and render of the
                first 100,000 query reads must accept at least 85,500;
                the first 2,000 query reads must give the JAX engine's
                count and report hash (REF_WIDE_DB_2K); (b) the whole query
                side, in the wide candidate format, against the first
                2,000 db reads: its count and report hash must equal the
                JAX engine's (REF_WIDE_QUERY).  Prints per part the engine
                build, index entries, compare and render walls,
                candidates, phases, stages and launches, and a traced warm
                run of each.
  9. enum    -- device candidate enumeration, Config(gate_enum=True), on
                the workloads of phases 4-6, each engine on its host-gate
                engine's index: the 20k (10,005 accepts), the long 512
                block (compare and render) and the long 20k (10,000 own
                copies) must give the host gate's pairs, candidates, NW
                cells and stage stats, and the 2k and long reports the JAX
                hashes; enum_candidates over the 20k's stage-2 window must
                equal the host build_flat's triples on the card.  Then the
                20k and the long 20k compare in turns on warm engines
                (host, enum, enum, host), each run's wall, gate phases and
                peak device memory printed, and a traced run of each
                enumerated compare.  Phase 8's paths are outside the
                enumeration's rules (the wide index; 2^21 padded query
                rows) and are skipped.
 10. mesh    -- one engine over a grid of four mesh positions on the one
                card (TorchEngine(..., mesh_devices=["cuda:0"] * 4),
                Config(mesh_shape=grid); phase_mesh): the 20k at (4, 1),
                (2, 2) and (1, 4) must give phase 4's pairs and report
                bytes, the 2k at (2, 2) the JAX hash; Config(gate_enum=True)
                at (2, 2) must take the host gate and give its pairs; the
                long 512 block at (2, 2) and (1, 4) its 256 accepts and JAX
                hash; phase 8's first 2,000 queries against the wide db at
                (1, 4), on phase 8's index split over the four positions,
                REF_WIDE_DB_2K; the whole wide query against 2,000 db reads
                at (2, 2), REF_WIDE_QUERY; imsame_tpu_torch.dryrun's
                dryrun_multichip(8), eight positions on the visible cards
                taken round-robin, a (4, 2) grid, its 32 of 64 accepts and
                its one-device engine's pairs and report.  Prints each
                part's walls, peak device memory and launches, the
                kernels' per-position batch shapes, and a traced warm
                compare of the 20k at (2, 2).  The
                kernels run at per-position batch shapes, but on one card
                this measures sharding overhead, not a multi-card speedup.
                With two cards or more it also runs the 20k on "auto" over
                them (its pairs and report) and the 2k on an engine on
                cuda:1 alone (the JAX hash); with one, it says it did not.
 11. 100k    -- bench.py large_bench's workload, synth_pair(100000, 250,
                0.5, seed=12345), through TorchEngine(db, Config(),
                device="cuda"): the index build, a cold compare and a cold
                render, timed; must accept 50,110 reads (bench.py
                accepted_ok), and the first 2,000 query reads against the
                same database must give the JAX engine's count and report
                hash (REF_100K_2K).  Prints the walls, query reads/s, the
                report's bytes and sha256, phases, stages, peak device
                memory, the kernels' batch shapes and a traced warm
                compare.

A long path that launches a kernel past L = 256 on more pairs than the
card holds at once fails unless phase 3 held such a batch at that
bucket.  Each path runs once more on the warm engine, traced by
torch.profiler: a "profile" line gives that run's device-busy share and
leading device work, then collects the trace's garbage (gc.collect), so
that no later timed compare pays the cyclic collector's pause for it;
timed compares report that pause and their CPU seconds (host.gc,
host.cpu).  Each path's kernel launches are counted from 0 just
before it and read just after, and every kernel, the gate included, must
have launched; on a path that renders, the traceback must run once for
each nw_forward launch; no path may run the plain gate on CUDA tensors
(PLAIN_GATE_ON_CARD).  The phases lines split the gate's host dispatch
into gate.encode, gate.upload and gate.launch.  The last three lines are a
JSON object with each kernel's launches on those paths, error, times and
bound, the card's name and power limit, then {"ok": true, "device": ...}.

With --config3 it runs phases 1-2, then bench_config3.py's workload whole
through the port (phase_config3): 1M x 1M reads of 250 bp written as
FASTA and read back by the port's streaming reader, the engine on the db
side, the query in 10 slices of 100,000 reads, slice 0 rendered; it must
give CONFIG3.json's 901,542 accepts and 80,279,236-byte slice-0 report
(exact semantics, not hardware) and the candidates and NW cells recorded
with the gate's rung, and prints its walls; slices 0 (copies) and 9
(random reads) run once more, traced.  With --config3 --gate-enum an
engine with device candidate enumeration on the same index then runs the
same 10 compares and the same checks, prints its align time and phase
sums beside the host gate's, and runs the traced slices.  Neither is
part of the default run.

With --ab PARENT [DIR] (PARENT another checkout, e.g. the parent commit
unpacked by git archive into build/parent) it runs phases 1-2, builds
the parent's kernels with the parent's own ops/nw_cuda.py, prints both
libraries' SASS sizes and cells loops, and times the two checkouts'
kernels in turns on every case of phase 3 (phase_ab; the gate's through
each side's ops/gate_cuda.py launch_gate, with L2 flushed, printing the
bases walked a second and the lane efficiency; the traceback's with L2
flushed, printing both sides' rounds), writing the rows and
SASS listings to DIR if given; it runs no plain version and no path.
With --ab-traceback CHECKOUT... it runs phases 1-2 and phase_ab's
traceback cases alone against each checkout (ab_traceback): the A/B of
the band's sizes, each variant a copy of this checkout with another
ops/nw_cuda.py TRACEBACK_BAND.
"""

import gc
import hashlib
import importlib.util
import json
import os
import random
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from imsame_tpu_torch import dryrun, native
from imsame_tpu_torch.bench_scaling import COUNTED, synth_pair
from imsame_tpu_torch.config import Config
from imsame_tpu_torch.constants import MAX_READ_SIZE
from imsame_tpu_torch.io.fasta import (
    SeqInfo, parse_fasta_bytes, read_fasta, read_fasta_stream,
    revcomp_fasta_bytes,
)
from imsame_tpu_torch.ops import (
    candidates, enum_gate, gate_cuda, nw, nw_cuda, resolve,
)
from imsame_tpu_torch.ops.extend import raw_score_threshold
from imsame_tpu_torch.ops import extend_packed as ext
from imsame_tpu_torch.ops.traceback import (
    RUN_FLAG, TracebackResult, traceback_batch,
)
from imsame_tpu_torch.orchestrator import AllVsAllRunner, list_samples, make_jobs
from imsame_tpu_torch.pipeline import (
    GATE_MAX_ELEMENTS, PACKED_MAX_READS, TorchEngine, build_flat,
)

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from util_synth import mutate, random_read, write_fasta  # noqa: E402

# sha256 of the report written by the JAX engine,
# imsame_tpu.pipeline.TpuEngine(db, Config(mesh_shape=None)) on the CPU, for
# the first 2,000 query reads of synth_pair(20000, 250, 0.5, seed=12345)
# against all 20,000 database reads (2,000 accepted, 1,599,831 bytes).
REF_2K_SHA256 = "36add83ee0c8ca80d331cf320f306c446ee44e4d28c43c93e18a762f1aded995"
REF_2K_ACCEPTED = 2000
ACCEPTED_20K = 10005  # the JAX engine's count on the whole workload
# sha256 of the report written by the JAX engine,
# TpuEngine(db, Config(mesh_shape=None, nw_stats_batches=(8,))) on the CPU,
# for bench.py longread_bench's 512 query and 512 db reads (256 accepted,
# 1,337,695 bytes).
REF_LONG_SHA256 = "80e63da61e10b3c35b1f7aa510d4e5d8add261c2edb767df37c04f432b43ee3a"
REF_LONG_ACCEPTED = 256
# Per job of the sweep of write_sweep_samples(dir, 2000): (accepted, sha256
# of the report) written by the JAX package's sweep,
# imsame_tpu.orchestrator.AllVsAllRunner(out, Config(mesh_shape=None)), on
# the CPU (the .r jobs accept nothing: the samples hold no reverse
# complements; their reports are empty).
REF_SWEEP_2K = {
    "s0-s1.align": (
        1000, "7b20082f241a8301960675b6e62109cd76228fe9b9c35a569e68eb4c0f13e8a3"),
    "s0-s1.r.align": (
        0, "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    "s0-s2.align": (
        1000, "bc0a17504e46e5377a35dfc2d2d4f45703b3f61d1d98c3790a59f5e87333c27e"),
    "s0-s2.r.align": (
        0, "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    "s0-s3.align": (
        1000, "c16e1c108fb65802608690c0ea63e4646f2dbc99e2a3c827fb914569914afe3b"),
    "s0-s3.r.align": (
        0, "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    "s1-s2.align": (
        1001, "367253d9c1b74d6635dbe18d68d8c3de956d865af090d412ed6a466d45720398"),
    "s1-s2.r.align": (
        0, "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    "s1-s3.align": (
        1001, "dc32a3eade51f9738cd112b0b7986e2f8cefe960be69cfa23af71b920441176f"),
    "s1-s3.r.align": (
        0, "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    "s2-s3.align": (
        1000, "c4356787a7dbb0ab1848bfc60f2623c9bc37352a972303094bae827eab0499c8"),
    "s2-s3.r.align": (
        0, "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
}
# Per job of the sweep of write_rc_samples(dir, RC_READS): (accepted, sha256
# of the report) written by the JAX package's sweep,
# imsame_tpu.orchestrator.AllVsAllRunner(out, Config(mesh_shape=None)), on
# the CPU.  Its samples hold reverse-complemented copies, so the .r jobs of
# an even and an odd sample accept reads.
REF_SWEEP_RC = {
    "s0-s1.align": (
        40, "4030ac740c4ec959825099eb899ca326fcfae8bdf364f71477268c459c63df82"),
    "s0-s1.r.align": (
        40, "06bc4862346c405de59ffe27610a6be3c7292860042363b9b43776e81e0ad053"),
    "s0-s2.align": (
        80, "0c894d8555cd0d06289c20cd08d9a6a2984a5dfa67ba074ebca5f327b45b2019"),
    "s0-s2.r.align": (
        0, "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    "s0-s3.align": (
        40, "4fd615c3f875ed01d66ccf3f52f28c73cf105c6854012cb9b7dc955363c4ca69"),
    "s0-s3.r.align": (
        40, "bf5ba7988c1ef6530ae1f09ddfd4f5794309cac118cfbcb5187430885b243d1e"),
    "s1-s2.align": (
        40, "d93865163cf2963d317fee4457ee16204c8ae42ea5503c665a73cbad909de8c4"),
    "s1-s2.r.align": (
        40, "7787cfbf459bc6e4f34aaf798190f858c922ac320cf2665819a902b4d25288ae"),
    "s1-s3.align": (
        80, "25f8cf7eed10344ebbe31db78b9dfca2b4b20e1b1dd36485a8bb426f3687f08e"),
    "s1-s3.r.align": (
        0, "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    "s2-s3.align": (
        40, "4e385a98cb7859a45ba87e992c48960b8167e47ad6ac5c653212c05316938b65"),
    "s2-s3.r.align": (
        40, "50bfda2764e33754f497cdc3f5f03ee95c3c6bda01c66e9e03876bd6fd2cd4e0"),
}
RC_READS = 120  # reads per sample of the reverse-complement anchor
# Config-3 (bench_config3.py): (read length, share of db reads that are
# query copies, substitution rate, seed) of synth_config3, and its Config.
CONFIG3_SHAPE = (250, 0.9, 0.02, 99)
WIDE_CONFIG = dict(first_window=32, first_window_auto=False)
N_WIDE = (1 << 20) + (1 << 15)  # reads a side of phase 8, past 2^20
CONFIG3_READS = 1_000_000  # reads a side of the --config3 run
CONFIG3_SLICE = 100_000  # query reads a compare (bench_config3.py slices)
# CONFIG3.json: the JAX engine's accepts, slice-0 report bytes,
# candidates and NW cells on the --config3 workload
CONFIG3_ACCEPTED = 901_542
CONFIG3_SLICE0_BYTES = 80_279_236
CONFIG3_CANDIDATES = 1_215_418_321
CONFIG3_NW_CELLS = 362_153_437_500
# At WIDE_CONFIG's first window of 32 and this index's mean bucket load
# (~14.2) the gate's rung engages (pipeline.rung_engages): the reads it
# resolves build no tails, so the port gates fewer candidates than the JAX
# engine.  The port's own candidates and NW cells on the --config3
# workload, recorded from an H100's run (not the JAX engine's; the counts
# do not depend on the hardware); both stay at most CONFIG3.json's.
CONFIG3_RUNG_CANDIDATES = 545_843_033
CONFIG3_RUNG_NW_CELLS = 184_912_250_000
# phase 8's query slice: bench_config3.py's 95 % of the db copies
WIDE_SLICE_MIN_ACCEPTED = 85_500
# (accepted, sha256 of the report) written by the JAX engine,
# imsame_tpu.pipeline.TpuEngine(db, Config(mesh_shape=None, **WIDE_CONFIG))
# on the CPU, on synth_config3(N_WIDE, *CONFIG3_SHAPE): the first 2,000
# query reads against the whole database, and the whole query against
# the first 2,000 database reads (tests/test_torch_scale.py wide_anchors).
REF_WIDE_DB_2K = (
    2000, "ad159533649da4c5d3097cdf2d64082c4295d8edc8048b0d03a626708c95feb5")
REF_WIDE_QUERY = (
    1855, "0e530d22a1564587f8e9bd9ae736925c7aa6fd3218639b642cc1657620ef9ef6")
N_100K = 100_000  # reads a side of phase 11 (bench.py large_bench)
ACCEPTED_100K = 50_110  # bench.py large_bench's expected_accepted
# (accepted, sha256 of the report) written by the JAX engine,
# imsame_tpu.pipeline.TpuEngine(db, Config(mesh_shape=None)) on the CPU,
# for the first 2,000 query reads of synth_pair(N_100K, 250, 0.5,
# seed=12345) against all 100,000 database reads
# (tests/test_torch_scale.py hundredk_anchor).
REF_100K_2K = (
    2000, "4beb36ae0bf3aebd825cc12b74bee9248edbabb55bec56f8b0eb570636610367")
SWEEP_READS = 20000  # reads per sample of the sweep (bench.py sweep_bench)
SUBPROCESS_TIMEOUT = 300  # seconds, each process of the two-process sweep
L = 256
LONG = (512, 1024, 2048, 3072)
IGAP, EGAP = -5, -2
BIG_B = 32768  # the long 20k compare's largest nw_stats launch (L = 3072)
# Integer operations one DP cell needs (ops/nw.py nw_stats_batch /
# nw_forward_batch): 3 candidates (3 adds), their max with the tie-break
# pick (2), the cell (1), the match terms (2), the path stats or from-word
# of the three moves and their select (5), the row tracker (compare, 2
# adds, 3 selects: 6) and the column tracker (6).
OPS_PER_CELL = 25
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s (data sheet)
CARD = {}  # "sms", "sm_hz" of the card, read by phase_device
KERNELS = {  # the NW kernels, on code rows: (wrapper, plain version)
    "nw_stats": (nw_cuda.nw_stats, nw.nw_stats_batch),
    "nw_forward": (nw_cuda.nw_forward, nw.nw_forward_batch),
}
# What each kernel replaces: nw_stats_batch_pallas_pipe4, _pipe3, _pipe2,
# _pipe and nw_stats_batch_pallas; nw_forward_batch_pallas_pipe5 and
# nw_forward_batch_pallas; the jitted jnp traceback_batch (not Pallas);
# the jitted jnp extend_packed and the gate functions that reach it
# (gate_core, flat_gate_packed, flat_gate_seg, flat_gate; not Pallas)
REPLACES = {
    "nw_stats": [f"imsame_tpu/ops/nw_pallas.py:{n}"
                 for n in (1953, 1104, 1449, 1528, 1619)],
    "nw_forward": [f"imsame_tpu/ops/nw_pallas.py:{n}" for n in (2307, 248)],
    "traceback": ["imsame_tpu/ops/traceback.py:136"],
    "gate": ["imsame_tpu/ops/extend_packed.py:123"]
    + [f"imsame_tpu/ops/candidates.py:{n}" for n in (29, 58, 95, 175)],
}
# Calls of the plain gate (ops/candidates.py gate_core) on CUDA tensors
# since the kernels phase: every path must leave it at 0 (the card runs
# the kernel, never the eager gate).
PLAIN_GATE_ON_CARD = [0]
# the render ladder's batches per bucket under the default 2 GiB budget
# (TorchEngine._render_sizes): nw_forward's and the traceback's cases
RENDER_BATCHES = {128: (2048,), 256: (2048,), 512: (1024,), 1024: (256,),
                  2048: (64, 8), 3072: (24, 8)}


def synth_config3(n: int, read_len: int, match_frac: float, sub_rate: float,
                  seed: int):
    """bench_config3.py's workload: n random query reads; match_frac of
    the db reads are copies of query reads with sub_rate substitutions, the
    rest random; the db shuffled."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (n, read_len), dtype=np.uint8)
    nm = int(n * match_frac)
    db = q[:nm].copy()
    mask = rng.random((nm, read_len)) < sub_rate
    db[mask] = (db[mask] + rng.integers(1, 4, int(mask.sum()), dtype=np.uint8)) % 4
    db = np.concatenate(
        [db, rng.integers(0, 4, (n - nm, read_len), dtype=np.uint8)]
    )
    return q, db[rng.permutation(n)]


def reads_to_seqinfo(reads) -> SeqInfo:
    """SeqInfo of a list (or [n, len] array) of uint8 code reads."""
    lens = np.array([len(r) for r in reads], np.int64)
    start = np.zeros(len(reads), np.int64)
    np.cumsum(lens[:-1], out=start[1:])
    fresh = np.zeros(int(lens.sum()), bool)
    fresh[start[lens > 0]] = True
    return SeqInfo(
        codes=np.concatenate(list(reads)).astype(np.uint8), start=start,
        fresh=fresh, headers=[b""] * len(reads),
    )


def mutate_np(rng, read: np.ndarray, sub: float, indel: float) -> np.ndarray:
    """tests/util_synth.py mutate in numpy: per base a deletion (indel/2),
    or an insertion of a random base before it (indel/2); a kept base is
    substituted with probability sub.  Cut to MAX_READ_SIZE."""
    n = len(read)
    r = rng.random(n)
    dele = r < indel / 2
    ins = (r >= indel / 2) & (r < indel)
    subd = rng.random(n) < sub
    base = np.where(subd, (read + rng.integers(1, 4, n)) % 4, read)
    reps = np.where(dele, 0, np.where(ins, 2, 1))
    out = np.repeat(base, reps).astype(np.uint8)
    first = np.cumsum(reps) - reps  # output slot of each base's first copy
    out[first[ins]] = rng.integers(0, 4, int(ins.sum()))
    return out[:MAX_READ_SIZE]


def mixed_pairs(rng, B: int, L: int = L):
    """Half mutated copies (substitutions, some with a shifted suffix that
    forces gap moves), half random; lengths 2..L, both ends included."""
    xlen = rng.integers(2, L + 1, B).astype(np.int32)
    ylen = rng.integers(2, L + 1, B).astype(np.int32)
    xlen[:4] = (2, L, 2, L)
    ylen[:4] = (2, L, L, 2)
    X = rng.integers(0, 4, (B, L)).astype(np.uint8)
    Y = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for b in range(4, B // 2):
        ylen[b] = xlen[b]
        Y[b] = X[b]
        mut = rng.random(L) < 0.08
        Y[b][mut] = (Y[b][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if b % 3 == 0 and xlen[b] > 8:
            cut = int(rng.integers(4, xlen[b] - 4))
            Y[b][cut:] = np.roll(Y[b][cut:], int(rng.integers(1, 4)))
    return to_cuda(X, Y, xlen, ylen)


def long_pairs(rng, B: int, L: int, degenerate: bool = False,
               lo_frac: float = 0.6):
    """tests/test_longreads.py's pairs: lengths lo_frac*L..L, half copies
    with 6% substitutions, every other one with a shifted suffix.  With
    `degenerate` the last 8 pairs get the lengths of degenerate_lengths."""
    lo = max(16, int(L * lo_frac))
    xlen = rng.integers(lo, L + 1, B).astype(np.int32)
    ylen = rng.integers(lo, L + 1, B).astype(np.int32)
    X = rng.integers(0, 4, (B, L)).astype(np.uint8)
    Y = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for b in range(B // 2):
        ylen[b] = xlen[b]
        Y[b] = X[b]
        mut = rng.random(L) < 0.06
        Y[b][mut] = (Y[b][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if b % 2 == 0:
            cut = int(rng.integers(8, max(9, xlen[b] - 8)))
            Y[b][cut:] = np.roll(Y[b][cut:], int(rng.integers(1, 5)))
    if degenerate:
        xlen[-8:], ylen[-8:] = degenerate_lengths(L)
    return to_cuda(X, Y, xlen, ylen)


def degenerate_lengths(L: int):
    """(xlen, ylen) of 8 pairs: empty and 1-base reads, and reads longer
    than the bucket L, which padding pairs (read 0) can be."""
    return ((0, 0, 1, 1, L, 2 * L + 5, 3 * L, 300),
            (0, 7, 1, L, 0, 2 * L - 3, 7, 3 * L))


def to_cuda(*arrs):
    return tuple(torch.as_tensor(a, device="cuda") for a in arrs)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up,
    each timed alone after a 128 MiB write has evicted the 50 MB L2: the
    launch finds its inputs in device memory, as the render's traceback
    finds most of the backpointers F wrote before it.  A 0.3 ms spin on
    the card (torch.cuda._sleep) follows the write, so that the card is
    still busy when the host has recorded the start event and launched
    fn: the time is the card's, not the host's launch overhead (tens of
    microseconds, more than a small launch takes)."""
    flush = torch.empty(32 << 20, dtype=torch.int32, device="cuda")
    spin = int(CARD.get("sm_hz", 2e9) * 3e-4)
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def timed_once(fn):
    """(fn(), milliseconds of that one call by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(got, want) -> int:
    """0 when every output equals its reference; raises otherwise (the
    error is taken 8 pairs at a time: a long batch's bp is tens of GB)."""
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            err = max(int((x.long() - y.long()).abs().max())
                      for x, y in zip(a.split(8), b.split(8)))
            raise AssertionError(f"kernel differs from plain: max err {err}")
    return 0


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    CARD["sm_hz"] = float(clk) * 1e6
    CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    print(smi)
    print(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, {CARD['sms']} SMs, "
        f"max SM clock {clk} MHz"
    )
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    native.build()
    if native.load() is None:
        raise RuntimeError("native host library did not load")
    print(f"build host.c (gcc): {time.perf_counter() - t0:.2f} s")
    build_kernels(nw_cuda, "")


def build_kernels(mod, label: str) -> str:
    """Builds the kernels of `mod` (an ops/nw_cuda.py module); prints the
    seconds and the ptxas report; returns the library's path."""
    info = mod.build()
    print(f"build nw kernels (nvcc sm_90a){label}: {info['seconds']:.2f} s")
    print(info["log"].strip())
    return info["path"]


def real_cells(args, Lb: int) -> int:
    """DP cells of the pairs inside the bucket: sum of xlen * ylen, each
    clamped to L."""
    xl, yl = (a.clamp(max=Lb).long() for a in args[2:4])
    return int((xl * yl).sum())


def bound(name: str, args, Lb: int):
    """(ms, "bytes" or "operations"): the least time the card could take
    for this call.  Operations: OPS_PER_CELL integer operations per real
    cell over the card's INT32 lanes (SMs x 64 x max SM clock).  Bytes:
    each input read once, each output written once, over HBM_BPS."""
    B = args[0].shape[0]
    ops_ms = real_cells(args, Lb) * OPS_PER_CELL / (
        CARD["sms"] * 64 * CARD["sm_hz"]) * 1e3
    out = 20 * B if name == "nw_stats" else B * ((2 * Lb - 1) * Lb * 4 + 12)
    bytes_ms = (2 * B * Lb + 8 * B + out) / HBM_BPS * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_case(cases, name, args, Lb, *, reps=5, timed=None, note="",
               plain_B=None):
    """Hold kernel `name` against its plain version on args (bucket Lb):
    one plain call on the first plain_B pairs (default: all), timed; the
    kernel on the whole batch, then on its first B pairs for each B in
    `timed` (default: the whole batch), each against the same plain result
    and timed."""
    wrapped, plain = KERNELS[name]
    n = args[0].shape[0]
    pb = plain_B or n
    want, plain_ms = timed_once(
        lambda: plain(*[a[:pb] for a in args], IGAP, EGAP, max_len=Lb))
    timed = sorted(set(timed or (n,)), reverse=True)
    err = max_abs_err([g[:pb] for g in wrapped(*args, IGAP, EGAP, max_len=Lb)],
                      want)
    for b in timed:
        part = [a[:b] for a in args]
        got = wrapped(*part, IGAP, EGAP, max_len=Lb)
        torch.cuda.synchronize()
        k = min(b, pb)
        err = max(err, max_abs_err([g[:k] for g in got],
                                   [w[:k] for w in want]))
        del got
        ms = cuda_ms(lambda: wrapped(*part, IGAP, EGAP, max_len=Lb), reps)
        top = b == timed[0]
        b_ms, b_by = bound(name, part, Lb)
        cells = real_cells(part, Lb)
        cases.append(dict(kernel=name, L=Lb, B=b, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms if top else None, plain_B=pb,
                          bound_ms=b_ms, bound_by=b_by, cells=cells,
                          note=note))
        print(f"{name:10s} L={Lb} B={b}{note}: equal, kernel {ms:.3f} ms"
              + (f", plain {plain_ms:.3f} ms (B={pb})" if top else "")
              + f", {cells / ms / 1e6:.2f} G real cells/s, bound {b_ms:.3f}"
              f" ms ({b_by}) = {100 * b_ms / ms:.1f} %")
    del want


def traceback_bound(tb, Lb: int):
    """(ms, "bytes") for a traceback call, by bound()'s convention: a
    32-byte sector of bp read per move (sum of n_steps), best_i / best_j
    read, the chain and the five stats written, over HBM_BPS.  The walk
    is a chain of dependent loads, so latency (max n_steps round trips)
    bounds it long before bytes do."""
    B = tb.chain.shape[0]
    moves = int(tb.n_steps.clamp(min=0).long().sum())
    return (32 * moves + 8 * B + B * 2 * Lb * 4 + 20 * B) / HBM_BPS * 1e3, \
        "bytes"


def tile_rounds(chain, Lb: int, band=None) -> np.ndarray:
    """The traceback kernel's dependent round trips to device memory for
    each pair, from its chain alone (csrc/traceback.cu): the band loads
    and the direct loads of cells no band can serve.  The walk's cells
    are decoded from the chain (a run entry relative to the cell before
    it, since a run's from-cell may have a negative coordinate).  A cell
    is served by the band held, anchored at (s0, c0), when its
    antidiagonal lies in [s0 - 2W + 1, s0], its i below L and its offset
    i - j within G of c0; else a cell with px + py <= 2L - 2 and px < L
    anchors a new band, and any other cell is one direct load (every
    cell, at W = 0: no band).  `band` is (W, G), by default
    nw_cuda.TRACEBACK_BAND[Lb]."""
    W, G = band or nw_cuda.TRACEBACK_BAND[Lb]
    ch = np.asarray(torch.as_tensor(chain).cpu(), np.int64)
    B, CH = ch.shape
    px, py = ch[:, 0] // nw.PACK, ch[:, 0] % nw.PACK
    s0 = np.full(B, -1, np.int64)  # no band yet
    c0 = np.zeros(B, np.int64)
    rounds = np.zeros(B, np.int64)
    act = (px > 0) & (py > 0)
    t = 0
    while act.any() and t < CH - 1:
        d = px + py
        k = s0 - d
        served = (k >= 0) & (k < 2 * W) & (px < Lb) & (
            np.abs(px - py - c0) <= G)
        new = act & ~served
        anchor = new & (W > 0) & (d <= 2 * Lb - 2) & (px < Lb)
        s0 = np.where(anchor, d, s0)
        c0 = np.where(anchor, px - py, c0)
        rounds += new
        e = ch[:, t + 1]
        run = (e < 0) | (e & RUN_FLAG != 0)
        v = np.where(e < 0, e, e & ~RUN_FLAG)
        r = (px * nw.PACK + py - v) // (nw.PACK + 1)
        px = np.where(act, np.where(run, px - r, v // nw.PACK), px)
        py = np.where(act, np.where(run, py - r, v % nw.PACK), py)
        act &= (px > 0) & (py > 0)
        t += 1
    return rounds


def check_traceback(cases, args, Lb, *, reps=5, timed=None, note="",
                    plain_B=None):
    """Hold the traceback kernel against the plain traceback_batch on the
    card, on nw_forward's outputs (the kernel's, launched uncounted) for
    the pairs `args`: as check_case, one plain call on the first plain_B
    pairs (default: all), timed; the kernel on the whole batch, then on
    its first B pairs for each B in `timed`, each against the same plain
    result and timed with L2 flushed before each launch (cuda_ms_cold)
    and repeated (cuda_ms: the words walked stay in L2).  Prints
    max(n_steps), the microseconds a move of the longest walk and the
    bound."""
    bp, _, bi, bj = nw_cuda.launch("nw_forward", *args, IGAP, EGAP,
                                   max_len=Lb)
    n = bp.shape[0]
    pb = plain_B or n
    want, plain_ms = timed_once(
        lambda: traceback_batch(bp[:pb], bi[:pb], bj[:pb], max_len=Lb))
    err = max_abs_err(
        [g[:pb] for g in nw_cuda.traceback(bp, bi, bj, max_len=Lb)], want)
    for b in sorted(set(timed or (n,)), reverse=True):
        part = (bp[:b], bi[:b], bj[:b])
        got = nw_cuda.traceback(*part, max_len=Lb)
        torch.cuda.synchronize()
        k = min(b, pb)
        err = max(err, max_abs_err([g[:k] for g in got],
                                   [w[:k] for w in want]))
        ms = cuda_ms_cold(lambda: nw_cuda.traceback(*part, max_len=Lb), reps)
        warm_ms = cuda_ms(lambda: nw_cuda.traceback(*part, max_len=Lb), reps)
        top = b == max(timed or (n,))
        steps = int(got.n_steps.max())
        rounds = tile_rounds(got.chain, Lb)
        b_ms, b_by = traceback_bound(got, Lb)
        del got
        cases.append(dict(kernel="traceback", L=Lb, B=b, max_abs_err=err,
                          ms=ms, warm_ms=warm_ms,
                          plain_ms=plain_ms if top else None,
                          plain_B=pb, bound_ms=b_ms, bound_by=b_by,
                          max_n_steps=steps, max_rounds=int(rounds.max()),
                          mean_rounds=float(rounds.mean()), note=note))
        print(f"traceback  L={Lb} B={b}{note}: equal, kernel {ms:.4f} ms "
              f"(L2 flushed; {warm_ms:.4f} ms repeated on warm L2)"
              + (f", plain {plain_ms:.3f} ms (B={pb})" if top else "")
              + f", max(n_steps) {steps}, {1e3 * ms / max(steps, 1):.3f} us"
              f" a move, rounds {rounds.max()} max / {rounds.mean():.2f} "
              f"mean, {1e3 * ms / max(rounds.max(), 1):.3f} us a round, "
              f"bound {1e3 * b_ms:.3f} us ({b_by}) = "
              f"{100 * b_ms / ms:.2f} %")
    del want, bp


TIE_KINDS = ("identical", "homopolymer", "period2", "mismatch", "prefix")


def tie_pairs(kind: str, L: int):
    """4 tie-heavy pairs of one kind at bucket L (numpy X, Y, xlen,
    ylen), where the best cell's (score, i, j) tie-break decides: two
    length pairs, then the same pairs with the reads swapped.  Kinds:
    identical reads, homopolymer against homopolymer, period-2 repeats (in
    phase, then shifted by one), all mismatches, one read a prefix of the
    other."""
    rng = np.random.default_rng(L)
    X = np.zeros((2, L), np.uint8)
    Y = np.zeros((2, L), np.uint8)
    xlen, ylen = (L, L // 2), (L // 2 + 1, L)
    if kind == "identical":
        X[:] = Y[:] = rng.integers(0, 4, L)
        xlen, ylen = (L - 3, L - 3), (L, L)
    elif kind == "period2":
        X[:, 1::2] = 1
        Y[0], Y[1, 0::2] = X[0], 1
        xlen, ylen = (L - 3, L // 2), (L, L - 2)
    elif kind == "mismatch":
        Y[:] = 2
    elif kind == "prefix":
        X[:] = Y[:] = rng.integers(0, 4, L)
        xlen, ylen = (L, L // 3), (L // 3, L)
    elif kind != "homopolymer":  # homopolymer: zeros on both sides
        raise ValueError(kind)
    xl = np.array(xlen + ylen, np.int32)
    yl = np.array(ylen + xlen, np.int32)
    return np.concatenate([X, Y]), np.concatenate([Y, X]), xl, yl


def big_pairs(rng, B: int, L: int):
    """The long 20k compare's largest launch at 3072: per pair one read of
    2049..3000 bp and the other of 300..3000 bp, in random order; half the
    pairs are near-copies (4 % substitutions, 1 % indels, as long_pair_np)."""
    X = rng.integers(0, 4, (B, L), dtype=np.uint8)
    Y = rng.integers(0, 4, (B, L), dtype=np.uint8)
    xlen = rng.integers(2049, 3001, B).astype(np.int32)
    ylen = rng.integers(300, 3001, B).astype(np.int32)
    for b in range(0, B, 2):  # every other pair a near-copy
        y = mutate_np(rng, X[b, :xlen[b]], 0.04, 0.01)
        Y[b, :len(y)] = y
        ylen[b] = len(y)
    swap = rng.random(B) < 0.5
    X[swap], Y[swap] = Y[swap].copy(), X[swap].copy()
    xlen[swap], ylen[swap] = ylen[swap].copy(), xlen[swap].copy()
    return to_cuda(X, Y, xlen, ylen)


def render_like_pairs(rng, B: int, L: int, lo: int, hi: int, indel: float):
    """B pairs of a read of lo..hi bp and its copy with 4 % substitutions
    and `indel` indels (mutate_np; the long 20k's copies have 1 %, the
    20k's none), cut to L: the accepted pairs a render walks."""
    X = rng.integers(0, 4, (B, L), dtype=np.uint8)
    Y = np.zeros((B, L), np.uint8)
    xlen = rng.integers(lo, hi + 1, B).astype(np.int32)
    ylen = np.zeros(B, np.int32)
    for b in range(B):
        y = mutate_np(rng, X[b, :xlen[b]], 0.04, indel)[:L]
        Y[b, :len(y)] = y
        ylen[b] = len(y)
    return to_cuda(X, Y, xlen, ylen)


def kernel_cases(rng):
    """Every kernel case, in order: (name, args, L, options of
    check_case).  A generator, so one case's tensors are alive at a time."""
    # degenerate pairs: an empty read can be read 0 of a sample, and read 0
    # fills the padding pairs of every NW batch
    X, Y, xlen, ylen = mixed_pairs(rng, 4)
    xlen[:] = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    ylen[:] = torch.tensor([0, 7, 1, L], dtype=torch.int32)
    for name in (*KERNELS, "traceback"):
        yield name, (X, Y, xlen, ylen), L, dict(reps=3, note=" [lengths 0, 1]")
    for Lb in (128, L):
        X, Y, xlen, ylen = mixed_pairs(rng, 8, Lb)
        for t, v in zip((xlen, ylen), degenerate_lengths(Lb)):
            t[:] = torch.tensor(v, dtype=torch.int32)
        for name in (*KERNELS, "traceback"):
            yield name, (X, Y, xlen, ylen), Lb, dict(
                reps=3, note=" [empty, over-long]")
    # tie-heavy pairs, where the best cell's tie-break decides; nw_forward
    # and the traceback also across 4 and 12 strips handing off
    for Lb in (L, 512, 1024, 3072):
        ties = [np.concatenate(a) for a in
                zip(*(tie_pairs(kind, Lb) for kind in TIE_KINDS))]
        for name in ((*KERNELS, "traceback") if Lb <= 512
                     else ("nw_forward", "traceback")):
            yield name, to_cuda(*ties), Lb, dict(reps=3, note=" [ties]")
    # the short path's shapes (as measured since the 256-bucket port)
    for name, B in (("nw_stats", 256), ("nw_stats", 2048),
                    ("nw_stats", 32768), ("nw_forward", 256),
                    ("nw_forward", 2048)):
        yield name, mixed_pairs(rng, B), L, dict(reps=10)
    # the long buckets at the compare (stats) and render (forward) batches
    for Lb in LONG:
        B = 2048 if Lb <= 1024 else 256
        yield "nw_stats", long_pairs(rng, B + 8, Lb, True), Lb, dict(
            timed=(B, 256))
    # the render ladder's top chunk and its 8-pair tail
    for Lb in LONG:
        B = RENDER_BATCHES[Lb][0]
        yield "nw_forward", long_pairs(rng, B + 8, Lb, True), Lb, dict(
            timed=(B, 8))
    # past the pairs resident on the card: nw_stats's warps loop over
    # pairs and reuse their strip scratch (the long compare's stats
    # batches at 2048 and 3072 hold thousands of pairs), nw_forward's
    # blocks run in waves; lengths from 0.05L so that short and long pairs
    # follow each other; nw_forward at 3072 held on a slice of 32 pairs
    for name, Lb, pb in (("nw_stats", 2048, None), ("nw_stats", 3072, None),
                         ("nw_forward", 512, None),
                         ("nw_forward", 3072, 32)):
        B = 2 * nw_cuda.resident_pairs(name, Lb) + 8
        yield name, long_pairs(rng, B + 8, Lb, True, 0.05), Lb, dict(
            reps=2, timed=(B,), plain_B=pb, note=" [> resident]")
    # the long 20k compare's largest launch, held on a slice of 2 x
    # resident warps + 8 pairs
    B = BIG_B
    yield "nw_stats", big_pairs(rng, B, 3072), 3072, dict(
        reps=2, plain_B=2 * nw_cuda.resident_pairs("nw_stats", 3072) + 8,
        note=" [long 20k launch]")
    # test shapes of the Pallas functions no path here takes as such
    for name, Lb, B, make, note in (
        ("nw_forward", 128, 8, mixed_pairs, " [nw_forward_batch_pallas]"),
        ("nw_stats", 128, 256, mixed_pairs, " [pipe2]"),
        ("nw_stats", 128, 512, mixed_pairs, " [pipe2]"),
        ("nw_stats", 256, 256, mixed_pairs, " [pipe2]"),
        ("nw_stats", 128, 128, mixed_pairs, " [pipe]"),
        ("nw_stats", 256, 64, mixed_pairs, " [pipe]"),
        ("nw_stats", 128, 16, mixed_pairs, " [nw_stats_batch_pallas]"),
        ("nw_stats", 512, 8, long_pairs, " [nw_stats_batch_pallas]"),
        ("nw_stats", 1024, 8, long_pairs, " [nw_stats_batch_pallas]"),
    ):
        yield name, make(rng, B, Lb), Lb, dict(reps=3, note=note)
    # the traceback on F's outputs at the render ladder's batches (past
    # 256 with the 8 degenerate pairs appended, as F's cases), then past
    # 2^31 bp words (3072 / 272 + 8 pairs: 5.3 G words, 64-bit offsets)
    for Lb, sizes in RENDER_BATCHES.items():
        B = sizes[0]
        pairs = (mixed_pairs(rng, B, Lb) if Lb <= L
                 else long_pairs(rng, B + 8, Lb, True))
        yield "traceback", pairs, Lb, dict(timed=sizes)
    yield "traceback", long_pairs(rng, 272 + 8, 3072, True), 3072, dict(
        reps=2, timed=(272,), note=" [> 2^31 words]")
    # the render walks accepted pairs only: high-identity copies (the
    # cases above are half random), the long 20k's with indels at its
    # 3072 chunk, the 20k's 250 bp reads at its 256 chunk
    yield "traceback", render_like_pairs(rng, 24, 3072, 2500, 3000,
                                         0.01), 3072, dict(
        note=" [render-like]")
    yield "traceback", render_like_pairs(rng, 2048, 256, 250, 250,
                                         0.0), 256, dict(
        note=" [render-like]")


GATE_FULL = 1 << 21  # Config.gate_chunks' largest chunk


def count_plain_gate() -> None:
    """Wraps the plain gate's body (ops/candidates.py gate_core, which
    every plain gate function calls) so that each call on CUDA tensors
    adds one to PLAIN_GATE_ON_CARD."""
    real = candidates.gate_core

    def counted(qp, *a, **k):
        PLAIN_GATE_ON_CARD[0] += qp.is_cuda
        return real(qp, *a, **k)

    candidates.gate_core = counted


def gate_workload(qr, dbr):
    """The gate's tables on the card for query reads `qr` and db reads
    `dbr` (code arrays) at their engine's window: (tables, indexes,
    candidates), where tables = (qp, dp, qlen, dlen, thr) as the engine
    builds them, indexes = {"packed": the index words, "wide": the
    (pos, sid, db_start) triple of the same index} and candidates =
    {"real": every candidate of the k-mer stream, "random": as many of
    random read ids, index rows (1 % past the table's end) and offsets
    (0 .. read length), in stream order}, host (rids, hits, qoffs)."""
    q, db = reads_to_seqinfo(qr), reads_to_seqinfo(dbr)
    eng = TorchEngine(db, Config(mesh_shape=None), device="cuda")
    qlens = q.read_lens()
    row_len = eng._nw_bucket(int(max(qlens.max(), eng.db_read_lens.max())))
    thr = raw_score_threshold(qlens, db.total_len, eng.cfg.min_e_value)
    tables = (eng._rows_on_device(q.codes, q.start, qlens, row_len),
              eng._packed_db_rows(row_len),
              *to_cuda(qlens.astype(np.int32)), eng._d_dlen,
              *to_cuda(np.asarray(thr, np.int32)))
    idx = eng.index
    indexes = {"packed": eng._d_idx_tab,
               "wide": to_cuda(np.asarray(idx.pos, np.int32),
                               np.asarray(idx.sid, np.int32),
                               np.asarray(db.start, np.int32))}
    stream = eng._kmer_stream(q)
    N_r = stream[5][1:] - stream[5][:-1]
    reads = np.flatnonzero(N_r)
    real = build_flat(stream, q.start.astype(np.int64), reads,
                      np.zeros(len(reads), np.int64), N_r[reads])
    rng = np.random.default_rng(row_len)
    n = len(real[0])
    r = rng.integers(0, q.n_seqs, n)
    qoff = rng.integers(0, qlens[r] + 1)
    order = np.lexsort((qoff, r))
    hits = rng.integers(0, int(idx.n_entries * 1.01), n)
    rand = (r[order].astype(np.int32), hits.astype(np.int32),
            qoff[order].astype(np.int32))
    return tables, indexes, {"real": real, "random": rand}, row_len


def gate_chunk(cols, take: int, size: int, fmt: str):
    """The first `take` candidates of host columns (rids, hits, qoffs) as
    one chunk of `size` slots in format `fmt` ("seg", "two", "three"):
    (cand, rtab, rbase) on the card, the padding slots zero."""
    take = min(take, len(cols[0]))
    rids, hits, qoffs = (c[:take] for c in cols)
    if fmt == "seg":
        return to_cuda(*candidates.encode_seg_chunk(rids, qoffs, hits, size))
    cand = np.zeros((2 if fmt == "two" else 3, size), np.int32)
    cand[0, :take] = hits
    if fmt == "two":
        cand[1, :take] = ((rids.astype(np.uint32) << np.uint32(12))
                          | qoffs.astype(np.uint32)).view(np.int32)
    else:
        cand[1, :take], cand[2, :take] = rids, qoffs
    return to_cuda(cand) + (None, None)


def gate_cases():
    """Every gate case: (note, W, tables, index payload, (cand, rtab,
    rbase), headline).  The 20k workload's rows (bucket 256; synth_pair
    as phase 4) and 2,000 long reads a side (bucket 3072; long_pair_np,
    seed 11): real and random candidates, in every format and both index
    payloads, at the windows 256 and 3072 in full chunks (2^21 and the
    engine's 87,360, GATE_MAX_ELEMENTS // 3072, some with padding slots),
    at 64 (the small tier) on both, and at 128, 512, 1024 and 2048 once
    each, at the engine's chunk for that window.  A generator: one
    workload's tables are alive at a time."""
    qc, dbc = synth_pair(20000, 250, 0.5, seed=12345)
    tabs, idx, cols, _ = gate_workload(qc, dbc)
    full = GATE_FULL
    for W, src, fmt, ix, n in (
            (256, "real", "seg", "packed", full),  # the headline case
            (256, "real", "two", "wide", full),
            (256, "real", "three", "packed", full),
            (256, "random", "seg", "wide", full),
            (256, "random", "two", "packed", full),
            (256, "random", "three", "wide", full),
            (64, "real", "seg", "packed", full),
            (64, "random", "two", "wide", full),
            (64, "real", "three", "wide", full - 4000),
            (128, "real", "two", "packed", full)):
        yield (f" {fmt} {ix} [{src}]", W, tabs, idx[ix],
               gate_chunk(cols[src], n, full, fmt), W == 256 and n == full
               and (src, fmt, ix) == ("real", "seg", "packed"))
    del tabs, idx, cols
    qr, dbr, _ = long_pair_np(2000, seed=11)
    tabs, idx, cols, _ = gate_workload(qr, dbr)
    big = GATE_MAX_ELEMENTS // 3072 // 32 * 32
    for W, src, fmt, ix, take, size in (
            (3072, "real", "seg", "packed", big - 37, big),
            (3072, "real", "two", "wide", big, big),
            (3072, "real", "three", "packed", big, big),
            (3072, "random", "seg", "wide", big, big),
            (3072, "random", "two", "packed", big, big),
            (3072, "random", "three", "wide", big - 37, big),
            (64, "real", "seg", "wide", 1 << 20, 1 << 20),
            (512, "real", "three", "packed", 1 << 19, 1 << 19),
            (1024, "random", "seg", "packed", 1 << 18, 1 << 18),
            (2048, "real", "two", "wide", 1 << 17, 1 << 17)):
        yield (f" {fmt} {ix} [{src}{', padded' if take < size else ''}]",
               W, tabs, idx[ix], gate_chunk(cols[src], take, size, fmt),
               False)


def walk_lengths(tabs, r, s, qoff, doff, W: int):
    """Bases each candidate's forward and backward walks compare (the
    plain walk's stop counts, ops/extend_packed.py), as int64."""
    qp, dp, qlen, dlen, _ = tabs
    o = torch.arange(W, dtype=torch.int32, device=qp.device)[None, :]
    fwd, bwd = ext.match_windows(qp, dp, r, s, qoff, doff, W)
    flim = torch.minimum(dlen[s] - 1 - doff, qlen[r] - 1 - qoff)
    S, nf, _ = ext.walk(fwd, flim, ext.SEED_SCORE, o, W)
    del fwd
    M = torch.where(o < nf[:, None], S, -(2**30)).amax(dim=1)
    del S
    seed = M.clamp(min=ext.SEED_SCORE)[:, None]
    _, nb, _ = ext.walk(bwd, torch.minimum(doff, qoff) - 13, seed, o, W)
    return nf.long(), nb.long()


def sectors(*words) -> int:
    """Distinct 32-byte sectors (8 int32 words) among word indexes into
    one table (int tensors, concatenated)."""
    return int(torch.unique(torch.cat([w.long() >> 3 for w in words]))
               .numel())


def span_words(row, b0, n, wp: int):
    """Word indexes into a [rows, wp] table of the bases b0 .. b0 + n - 1
    of each row (spans of n <= 0 bases read nothing): every word of
    every span, flat."""
    keep = n > 0
    row, b0, n = row[keep].long(), b0[keep].long(), n[keep]
    lo = row * wp + (b0 >> 4).clamp(0, wp - 1)
    cnt = row * wp + ((b0 + n - 1) >> 4).clamp(0, wp - 1) - lo + 1
    first = torch.cumsum(cnt, 0) - cnt
    step = torch.arange(int(cnt.sum()), device=row.device)
    return torch.repeat_interleave(lo - first, cnt) + step


def lane_efficiency(nf, nb) -> float:
    """The share of the gate kernel's lanes busy on its 8-base steps: the
    candidates' steps (ceil(nf / 8) + ceil(nb / 8)) over 32 lanes times
    each warp's longest forward walk plus its longest backward walk, in
    steps, with warps of 32 consecutive candidates in launch order
    (padding slots are lanes too).  A diagnostic of divergence beside the
    byte bound, not a bound."""
    steps = torch.stack([(nf + 7) // 8, (nb + 7) // 8]).view(2, -1, 32)
    return float(steps.sum()) / max(32 * int(steps.amax(dim=2).sum()), 1)


def gate_bound(tabs, idx_tab, cand, rtab, rbase, W: int):
    """(ms, "bytes", bases walked, lane efficiency) for a gate call: the
    bytes that the call must move, each once, over HBM_BPS.  The candidate words (and
    the seg format's 8 bytes a segment) and the output words, and the
    distinct 32-byte sectors of every table that the call reads: the
    index entries of the candidates' hits (the packed word, or the wide
    pos and sid and the db_start of their db reads), thr and qlen of
    their query reads, dlen of their db reads, and the row words that
    their two walks cover on either side (walk_lengths on these
    inputs); the bases walked and lane_efficiency of those walks."""
    qp, dp, qlen, dlen, thr = tabs
    r, hit, qoff = candidates.decode_candidates(cand, rtab, rbase)
    wide = not isinstance(idx_tab, torch.Tensor)
    n_idx = (idx_tab[0] if wide else idx_tab).shape[0]
    hit = hit.clamp(0, n_idx - 1)
    s, doff = candidates.lookup_index(idx_tab, hit)
    nf, nb = walk_lengths(tabs, r, s, qoff, doff, W)
    # the backward walk covers bases off - 12 - nb .. off - 13
    rows = (sectors(span_words(r, qoff, nf, qp.shape[1]),
                    span_words(r, qoff - 12 - nb, nb, qp.shape[1]))
            + sectors(span_words(s, doff, nf, dp.shape[1]),
                      span_words(s, doff - 12 - nb, nb, dp.shape[1])))
    table = (2 if wide else 1) * sectors(hit) + 2 * sectors(r) \
        + (2 if wide else 1) * sectors(s)
    nbytes = (4 * cand.numel() + (8 * rtab.numel() if rtab is not None else 0)
              + 32 * (table + rows) + cand.shape[-1] // 4)
    return (nbytes / HBM_BPS * 1e3, "bytes", int((nf + nb).sum()),
            lane_efficiency(nf, nb))


def differing_bits(got, want) -> int:
    """Bits in which two [2, N/32] int32 word arrays differ."""
    x = (got ^ want).view(torch.uint8).cpu().numpy()
    return int(np.unpackbits(x).sum())


def check_gate(cases, note, W, tabs, idx_tab, chunk, headline, reps=5):
    """Hold the gate kernel's wrapper (ops/gate_cuda.py gate) against the
    plain gate (ops/candidates.py gate_plain) on the card, bit for bit on
    every word of [2, N/32]:
    the plain call timed once, the kernel timed with L2 flushed before
    each launch (cuda_ms_cold), and the bound (gate_bound)."""
    cand, rtab, rbase = chunk
    qp, dp, qlen, dlen, thr = tabs
    args = (qp, dp, qlen, dlen, idx_tab, cand, thr, rtab, rbase)
    want, plain_ms = timed_once(
        lambda: candidates.gate_plain(*args, window=W))
    got = gate_cuda.gate(*args, window=W)
    torch.cuda.synchronize()
    err = differing_bits(got, want)
    if err:
        raise AssertionError(f"gate W={W}{note}: {err} bits differ from the "
                             "plain gate")
    N = want.shape[1] * 32
    n_pass, n_exact = (int(np.unpackbits(w.view(torch.uint8).cpu().numpy())
                           .sum()) for w in want)
    del got, want
    ms = cuda_ms_cold(lambda: gate_cuda.gate(*args, window=W), reps)
    b_ms, b_by, walked, eff = gate_bound(tabs, idx_tab, cand, rtab, rbase, W)
    cases.append(dict(kernel="gate", L=W, B=N, max_abs_err=err, ms=ms,
                      plain_ms=plain_ms, plain_B=N, bound_ms=b_ms,
                      bound_by=b_by, note=note, headline=headline,
                      walked=walked, lane_efficiency=eff))
    print(f"gate       W={W} N={N}{note}: equal (0 bits differ), kernel "
          f"{ms:.3f} ms (L2 flushed), plain {plain_ms:.3f} ms, "
          f"{N / ms / 1e6:.2f} G candidates/s, {walked / N:.1f} bases walked"
          f" a candidate, {walked / ms / 1e6:.1f} G bases/s, lane efficiency "
          f"{eff:.3f}, {n_pass} pass, {n_exact} exact, bound "
          f"{b_ms:.3f} ms ({b_by}) = {100 * b_ms / ms:.1f} %")


def phase_kernels() -> list:
    """Each kernel against its plain version, bit for bit."""
    cases = []
    for name, args, Lb, opts in kernel_cases(np.random.default_rng(20260)):
        if name == "traceback":
            check_traceback(cases, args, Lb, **opts)
        else:
            check_case(cases, name, args, Lb, **opts)
    for case in gate_cases():
        check_gate(cases, *case)
        del case
    for Lb in (128, L) + LONG:
        print(f"resident pairs nw_stats L={Lb}: "
              f"{nw_cuda.resident_pairs('nw_stats', Lb)}, nw_forward: "
              f"{nw_cuda.resident_pairs('nw_forward', Lb)}")
    return cases


def sass_loops(so: str, tag: str, out_dir: str | None) -> None:
    """Per kernel instantiation of the library `so`: its SASS instruction
    count (cuobjdump -sass) and its cells loop: the smallest loop (a
    backward branch's span) with at least 9 shuffles and no warp
    collective (those are the pair's epilogue), printed with its static
    instruction and shuffle counts; its cold blocks (best-cell offers,
    boundary ring) are included.  With `out_dir` the whole listing goes
    to out_dir/sass_<tag>.txt."""
    tool = str(Path(nw_cuda._nvcc()).with_name("cuobjdump"))
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                         timeout=300).stdout
    if out_dir:
        Path(out_dir, f"sass_{tag}.txt").write_text(out)
    for part in out.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        kn = re.search(r"(nw_\w+?)_kernelILi(\d+)ELi(\d+)E", name)
        if not kn:
            continue
        ins = [(int(a, 16), t) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;\n]*);", part)]
        at = {a: i for i, (a, _) in enumerate(ins)}
        best = None
        for i, (a, t) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)
            if not m or int(m[1], 16) >= a or int(m[1], 16) not in at:
                continue
            body = [x for _, x in ins[at[int(m[1], 16)]:i + 1]]
            shfl = sum("SHFL" in x for x in body)
            if shfl >= 9 and not any("ENDCOLLECTIVE" in x for x in body) \
                    and (best is None or len(body) < best[0]):
                best = (len(body), shfl)
        loop = (f"cells loop {best[0]} instructions, {best[1]} shuffles"
                if best else "no cells loop found")
        print(f"sass {tag} {kn[1]} K={kn[2]} NS={kn[3]}: {len(ins)} "
              f"instructions; {loop}")


def checkout_nw_cuda(root: str):
    """ops/nw_cuda.py of another checkout (e.g. the parent commit unpacked
    by git archive), imported with that checkout's own imsame_tpu_torch
    as a package of another name; its kernels build into that
    checkout's build/."""
    pkg = Path(root).resolve() / "imsame_tpu_torch"
    name = "ab_" + re.sub(r"\W", "_", str(pkg.parent))
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.nw_cuda")


def resident(mod, kernel: str, Lb: int) -> int:
    """Pairs of `kernel` in flight on the card at once, by the nw_cuda
    module `mod` (resident_slots in checkouts before nw_forward's strips
    ran on parallel warps)."""
    fn = getattr(mod, "resident_pairs", None) or mod.resident_slots
    return fn(kernel, Lb)


def phase_ab(parent: str, out_dir: str | None = None) -> None:
    """Times the kernels of another checkout (`parent`, e.g. the parent
    commit unpacked with git archive) and of this one on the same inputs,
    in turns (parent, this, this, parent), on every kernel case; this
    checkout's outputs must equal the parent's bit for bit.  Each side
    launches through its own ops/nw_cuda.py (the gate through its own
    ops/gate_cuda.py, ab_gate); the traceback's and the gate's cases are
    timed with L2 flushed before each launch (ab_traceback_case,
    ab_gate), the NW kernels' on repeated launches.  Prints one line per
    case;
    runs no plain version.  With `out_dir` it also writes the rows
    (out_dir/ab_kernels.json) and both SASS listings there."""
    pmod = checkout_nw_cuda(parent)
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
    libs = {"parent": build_kernels(pmod, f" of {parent}"),
            "new": nw_cuda.build()["path"]}
    for who, so in libs.items():
        print(f"{who}:")
        sass_loops(so, who, out_dir)
    rows = []
    skipped = 0
    for name, args, Lb, opts in kernel_cases(np.random.default_rng(20260)):
        cells = real_cells(args, Lb)
        if name == "traceback":
            if hasattr(pmod, "launch_traceback"):
                rows += ab_traceback_case({"parent": pmod}, args, Lb, opts)
            else:
                skipped += 1
            continue
        runs = {
            "parent": lambda: pmod.launch(name, *args, IGAP, EGAP,
                                          max_len=Lb),
            "new": lambda: nw_cuda.launch(name, *args, IGAP, EGAP,
                                          max_len=Lb),
        }
        b_ms, b_by = bound(name, args, Lb)
        err = max_abs_err(runs["new"](), runs["parent"]())
        reps = opts.get("reps", 5)
        t = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            t[who].append(cuda_ms(runs[who], reps))
        pm, nm = (sum(t[w]) / 2 for w in ("parent", "new"))
        rate = f"{cells / pm / 1e6:.2f} -> {cells / nm / 1e6:.2f} G cells/s"
        rows.append(dict(kernel=name, L=Lb, B=args[0].shape[0],
                         note=opts.get("note", ""), parent_ms=t["parent"],
                         new_ms=t["new"], max_abs_err=err, cells=cells,
                         bound_ms=b_ms, bound_by=b_by))
        print(f"ab {name:10s} L={Lb} B={args[0].shape[0]}"
              f"{opts.get('note', '')}: equal to parent; parent "
              f"{pm:.3f} ms, new {nm:.3f} ms, new/parent {nm / pm:.3f}; "
              f"{rate}; bound {b_ms:.3f} ms ({b_by})")
        del args, runs
    if skipped:
        print(f"ab traceback: {skipped} cases skipped: {parent} has no "
              "traceback kernel (ops/nw_cuda.py launch_traceback)")
    rows += ab_gate(parent, pmod)
    for Lb in (128, L) + LONG:
        print(f"resident pairs L={Lb}: " + ", ".join(
            f"{k} parent {resident(pmod, k, Lb)}, new "
            f"{nw_cuda.resident_pairs(k, Lb)}" for k in KERNELS))
    if out_dir:
        Path(out_dir, "ab_kernels.json").write_text(json.dumps(rows, indent=1))


def ab_traceback_case(sides: dict, args, Lb: int, opts: dict) -> list:
    """One traceback case of the A/B: the nw_forward kernel's outputs of
    this checkout on the pairs `args`, walked by this checkout's kernel and
    by each side's (name -> another checkout's ops/nw_cuda.py), whose
    outputs must equal this checkout's bit for bit; each side timed in
    turns with this checkout (side, this, this, side), 20 launches each,
    with L2 flushed before each launch (cuda_ms_cold): the render finds
    F's words in device memory.  Prints max(n_steps), both sides' band rounds
    (tile_rounds; a side without TRACEBACK_BAND makes one round trip a
    move) and this checkout's microseconds a round; returns the rows."""
    bp, _, bi, bj = nw_cuda.launch("nw_forward", *args, IGAP, EGAP,
                                   max_len=Lb)

    def new():
        return nw_cuda.launch_traceback(bp, bi, bj, max_len=Lb)

    tb = TracebackResult(*new())
    B, note = bp.shape[0], opts.get("note", "")
    steps = int(tb.n_steps.max())
    rounds = tile_rounds(tb.chain, Lb)
    b_ms, b_by = traceback_bound(tb, Lb)
    rows = []
    for who, mod in sides.items():
        def old():
            return mod.launch_traceback(bp, bi, bj, max_len=Lb)

        err = max_abs_err(new(), old())
        band = getattr(mod, "TRACEBACK_BAND", {}).get(Lb)
        theirs = (tile_rounds(tb.chain, Lb, band) if band
                  else tb.n_steps.clamp(min=0).cpu().numpy())
        t = {who: [], "new": []}
        for w in (who, "new", "new", who):
            t[w].append(cuda_ms_cold(new if w == "new" else old, 20))
        pm, nm = (sum(t[w]) / 2 for w in (who, "new"))
        rows.append(dict(kernel="traceback", L=Lb, B=B, note=note, side=who,
                         parent_ms=t[who], new_ms=t["new"], max_abs_err=err,
                         max_n_steps=steps, max_rounds=int(rounds.max()),
                         mean_rounds=float(rounds.mean()),
                         side_max_rounds=int(theirs.max()),
                         side_band=band, bound_ms=b_ms, bound_by=b_by))
        print(f"ab traceback  L={Lb} B={B}{note}: equal to {who}; {who} "
              f"{pm:.4f} ms, new {nm:.4f} ms (L2 flushed), new/{who} "
              f"{nm / pm:.3f}; max(n_steps) {steps}; rounds {who} "
              f"{theirs.max()} max / {theirs.mean():.2f} mean, new "
              f"{rounds.max()} max / {rounds.mean():.2f} mean, "
              f"{1e3 * pm / max(theirs.max(), 1):.3f} -> "
              f"{1e3 * nm / max(rounds.max(), 1):.3f} us a round; bound "
              f"{1e3 * b_ms:.3f} us ({b_by})")
    return rows


def ab_traceback(sides: dict) -> list:
    """phase_ab's traceback cases alone, each against every side (name
    -> another checkout's ops/nw_cuda.py, built): the A/B of the band's
    variants.  The other kernel cases' inputs are drawn but not run, so
    each case's pairs are phase_ab's."""
    rows = []
    for name, args, Lb, opts in kernel_cases(np.random.default_rng(20260)):
        if name == "traceback":
            rows += ab_traceback_case(sides, args, Lb, opts)
        del args
    return rows


def ab_gate(parent: str, pmod) -> list:
    """phase_ab's gate cases: every gate_cases chunk through the parent's
    and this checkout's ops/gate_cuda.py launch_gate, timed in turns
    (parent, this, this, parent) with L2 flushed before each launch, this
    checkout's words bit-equal to the parent's; returns the rows.  A
    parent without a gate kernel skips them and says so."""
    try:
        pgate = importlib.import_module(
            pmod.__name__.rsplit(".", 1)[0] + ".gate_cuda")
    except ModuleNotFoundError:
        pgate = None
    rows, skipped = [], 0
    for note, W, tabs, idx_tab, (cand, rtab, rbase), _ in gate_cases():
        if pgate is None:
            skipped += 1
            continue
        args = (*tabs[:4], idx_tab, cand, tabs[4], rtab, rbase)
        runs = {"parent": lambda: pgate.launch_gate(*args, window=W),
                "new": lambda: gate_cuda.launch_gate(*args, window=W)}
        err = differing_bits(runs["new"](), runs["parent"]())
        if err:
            raise AssertionError(f"ab gate W={W}{note}: {err} bits differ "
                                 "from the parent's")
        t = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            t[who].append(cuda_ms_cold(runs[who], 5))
        pm, nm = (sum(t[w]) / 2 for w in ("parent", "new"))
        b_ms, b_by, walked, eff = gate_bound(tabs, idx_tab, cand, rtab,
                                             rbase, W)
        N = cand.shape[-1]
        rows.append(dict(kernel="gate", L=W, B=N, note=note,
                         parent_ms=t["parent"], new_ms=t["new"],
                         max_abs_err=err, walked=walked,
                         lane_efficiency=eff, bound_ms=b_ms, bound_by=b_by))
        print(f"ab gate       W={W} N={N}{note}: equal to parent (0 bits "
              f"differ); parent {pm:.3f} ms, new {nm:.3f} ms, new/parent "
              f"{nm / pm:.3f}; {walked / N:.1f} bases walked a candidate, "
              f"{walked / pm / 1e6:.1f} -> {walked / nm / 1e6:.1f} G bases/s,"
              f" lane efficiency {eff:.3f}; bound {b_ms:.3f} ms ({b_by})")
        del args, runs
    if skipped:
        print(f"ab gate: {skipped} cases skipped: {parent} has no gate "
              "kernel (ops/gate_cuda.py)")
    return rows


def warm(label: str, fn):
    """(fn(), its wall seconds) for a run on a warm engine, traced by
    torch.profiler.  Prints the share of that wall during which the device
    was busy (the union of the device-side events' intervals: kernels,
    copies, sets), the device work that leads it and the gate's and the
    traceback's kernel time; the profiler's own cost is in that wall."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, per = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        n, t = per.get(e.name, (0, 0.0))
        per[e.name] = (n + 1, t + (b - a) / 1e3)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:4]
    # the gate's kernels (csrc/gate.cu: the gate and the seg scans)
    gate = [v for k, v in per.items()
            if re.search(r"\b(gate_kernel|seg_totals_kernel|seg_scan_kernel)",
                         k)]
    # the traceback's, one instantiation a bucket
    walk = [v for k, v in per.items() if re.search(r"\btraceback_kernel", k)]
    # the trace's events hold reference cycles: collect them here, or
    # the cyclic collector's pause lands in a later timed compare
    del prof
    t_gc = time.perf_counter()
    n_gc = gc.collect()
    t_gc = time.perf_counter() - t_gc
    print(f"profile {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms = {100 * busy / (wall * 1e3):.1f} %, leading: "
          + "; ".join(f"{k[:48]} {t:.1f} ms ({n})" for k, (n, t) in top)
          + f"; gate kernels {sum(t for _, t in gate):.2f} ms "
          f"({sum(n for n, _ in gate)}); traceback kernels "
          f"{sum(t for _, t in walk):.2f} ms ({sum(n for n, _ in walk)}); "
          f"then gc.collect() {n_gc} objects in {t_gc:.3f} s")
    return out, wall


def zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def check_render_launches(label: str, launches: dict) -> None:
    """A rendering path walks every F chunk with one traceback launch,
    and no path runs the plain gate on the card."""
    if launches["traceback"] != launches["nw_forward"]:
        raise AssertionError(f"{label}: traceback launches differ from "
                             f"nw_forward's: {launches}")
    if PLAIN_GATE_ON_CARD[0]:
        raise AssertionError(f"{label}: the plain gate ran on CUDA tensors "
                             f"{PLAIN_GATE_ON_CARD[0]} times")


def phase_slice(keep: dict) -> dict:
    """The 20k x 20k compare and render, and the 2k report hash; leaves
    its query, engine, result and stages in keep["20k"] for phase 9."""
    qc, dbc = synth_pair(20000, 250, 0.5, seed=12345)
    q, db = reads_to_seqinfo(qc), reads_to_seqinfo(dbc)
    zero_counts()
    t0 = time.perf_counter()
    eng = TorchEngine(db, Config(), device="cuda")
    t1 = time.perf_counter()
    res = eng.compare(q)
    t2 = time.perf_counter()
    report = eng.render_report(q, res)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = read_counts()
    print(f"20k: engine init {t1 - t0:.3f} s, compare {t2 - t1:.3f} s, "
          f"render {t3 - t2:.3f} s, accepted {res.accepted}, "
          f"candidates {res.n_candidates}, nw_cells {res.nw_cells}, "
          f"report {len(report)} B, launches {launches}")
    print("20k phases: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(res.timings.items())}))
    print("20k stages: " + json.dumps(eng.stage_stats))
    q2 = reads_to_seqinfo(qc[:2000])
    keep["20k"] = dict(q=q, q2=q2, db=db, eng=eng, res=res,
                       stages=dict(eng.stage_stats), report=report)
    if res.accepted != ACCEPTED_20K:
        raise AssertionError(f"20k accepted {res.accepted} != {ACCEPTED_20K}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    check_render_launches("20k", launches)
    if [a.qread for a in res.records] != sorted({a.qread for a in res.records}):
        raise AssertionError("records are not one per read in read order")

    # steady state: the same compare again on the warm engine
    res_w, t_c = warm("20k compare", lambda: eng.compare(q))
    report_w, t_r = warm("20k render", lambda: eng.render_report(q, res_w))
    print(f"20k warm (profiled): compare {t_c:.3f} s, render {t_r:.3f} s")
    if report_w != report:
        raise AssertionError("a second compare gave another report")

    res2 = eng.compare(q2)
    sha = hashlib.sha256(eng.render_report(q2, res2)).hexdigest()
    print(f"2k: accepted {res2.accepted}, report sha256 {sha}")
    if res2.accepted != REF_2K_ACCEPTED or sha != REF_2K_SHA256:
        raise AssertionError("2k report differs from the JAX engine's")
    return launches


def assert_checked(shapes: dict, cases: list) -> None:
    """Fails if a path launched a kernel past L = 256 on more pairs than
    the card holds at once (nw_stats: its warp slots, which then loop over
    pairs; nw_forward: its blocks, which then run in waves), at a bucket
    where the kernels phase held no such batch against the plain
    version."""
    for name, rows in shapes.items():
        for Lb, B in set(rows):
            n = nw_cuda.resident_pairs(name, Lb)
            if Lb > nw_cuda.STRIP and B > n and not any(
                c["kernel"] == name and c["L"] == Lb and c["plain_B"] > n
                for c in cases
            ):
                raise AssertionError(
                    f"{name} ran B={B} > {n} resident pairs at L={Lb}, "
                    "a shape no kernel case checked")


def print_shapes(label: str, shapes: dict) -> None:
    """Each kernel's launches per bucket: their batch sizes."""
    for name, rows in shapes.items():
        per = {}
        for Lb, B in rows:
            per.setdefault(Lb, []).append(B)
        print(f"{label} {name} batches per bucket: "
              + json.dumps({str(k): v for k, v in sorted(per.items())}))


def record_shapes(shapes: dict):
    """Wrap the resolve step's kernel calls to record each launch's
    (L, B); returns a function that restores them."""
    saved = {}
    for name in KERNELS:
        real = getattr(resolve, name)
        saved[name] = real

        def rec(X, *a, _real=real, _name=name, **k):
            shapes.setdefault(_name, []).append((X.shape[1], X.shape[0]))
            return _real(X, *a, **k)

        setattr(resolve, name, rec)
    return lambda: [setattr(resolve, n, f) for n, f in saved.items()]


def phase_long(cases: list, keep: dict) -> dict:
    """bench.py longread_bench's workload, compare and render; leaves its
    query, engine and result in keep["long"] for phase 9."""
    rng = random.Random(4242)
    nq = 512
    q_reads = [random_read(rng, rng.randint(300, 3000)) for _ in range(nq)]
    db_reads = [
        mutate(rng, q_reads[i], 0.04, 0.01)
        if i % 2 == 0
        else random_read(rng, rng.randint(300, 3000))
        for i in range(nq)
    ]
    rng.shuffle(db_reads)
    with tempfile.TemporaryDirectory() as td:
        write_fasta(Path(td) / "q.fa", q_reads, "q")
        write_fasta(Path(td) / "db.fa", db_reads, "d")
        q = read_fasta(str(Path(td) / "q.fa"))
        db = read_fasta(str(Path(td) / "db.fa"))
    shapes = {}
    restore = record_shapes(shapes)
    try:
        zero_counts()
        t0 = time.perf_counter()
        eng = TorchEngine(db, Config(), device="cuda")
        t1 = time.perf_counter()
        res = eng.compare(q)
        t2 = time.perf_counter()
        report = eng.render_report(q, res)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = read_counts()
    finally:
        restore()
    sha = hashlib.sha256(report).hexdigest()
    print(f"long: engine init {t1 - t0:.3f} s, compare {t2 - t1:.3f} s, "
          f"render {t3 - t2:.3f} s, accepted {res.accepted}, "
          f"candidates {res.n_candidates}, nw_cells {res.nw_cells}, "
          f"report {len(report)} B, sha256 {sha}, launches {launches}")
    print("long phases: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(res.timings.items())}))
    print("long stages: " + json.dumps(eng.stage_stats))
    keep["long"] = dict(q=q, db=db, eng=eng, res=res,
                        stages=dict(eng.stage_stats), report=report)
    print_shapes("long", shapes)
    assert_checked(shapes, cases)
    res_w, t_c = warm("long compare", lambda: eng.compare(q))
    report_w, t_r = warm("long render", lambda: eng.render_report(q, res_w))
    print(f"long warm (profiled): compare {t_c:.3f} s, render {t_r:.3f} s")
    if res.accepted != REF_LONG_ACCEPTED or sha != REF_LONG_SHA256:
        raise AssertionError("long-read report differs from the JAX engine's")
    if report_w != report:
        raise AssertionError("a second long compare gave another report")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    check_render_launches("long", launches)
    if (3072, 24) not in shapes.get("nw_forward", []):
        raise AssertionError("nw_forward ran no 24-pair chunk at L = 3072")
    return launches


def long_pair_np(n: int, seed: int):
    """n query reads of 300..3000 bp; half the db reads are copies of
    query reads (4% substitutions, 1% indels), the rest random; shuffled.
    Returns (query reads, db reads, perm): db read k copies query read
    perm[k] when perm[k] < n // 2."""
    rng = np.random.default_rng(seed)
    q = [rng.integers(0, 4, int(n_), dtype=np.uint8)
         for n_ in rng.integers(300, 3001, n)]
    nm = n // 2
    db = [mutate_np(rng, q[i], 0.04, 0.01) for i in range(nm)]
    db += [rng.integers(0, 4, int(n_), dtype=np.uint8)
           for n_ in rng.integers(300, 3001, n - nm)]
    perm = rng.permutation(n)
    return q, [db[k] for k in perm], perm


def checked_traceback(checked: list):
    """Wrap the render resolve's traceback kernel so that the first chunk
    of each bucket is also walked by the plain traceback_batch on the
    card, which its six outputs must equal; appends (L, B, max(n_steps))
    of each held chunk to `checked`.  Returns a function that restores
    the kernel's wrapper."""
    real = resolve.traceback

    def check(bp, best_i, best_j, *, max_len):
        got = real(bp, best_i, best_j, max_len=max_len)
        if all(c[0] != max_len for c in checked):
            want = traceback_batch(bp, best_i, best_j, max_len=max_len)
            max_abs_err(got, want)
            checked.append((max_len, bp.shape[0], int(want.n_steps.max())))
        return got

    resolve.traceback = check
    return lambda: setattr(resolve, "traceback", real)


def phase_long20k(cases: list, keep: dict) -> dict:
    """The long 20k compare and render of its 10,000 accepts; leaves its
    query, engine, result and the copies' permutation in keep["long20k"]
    for phase 9."""
    t0 = time.perf_counter()
    qr, dbr, perm = long_pair_np(20000, seed=2024)
    q, db = reads_to_seqinfo(qr), reads_to_seqinfo(dbr)
    print(f"long20k: data {time.perf_counter() - t0:.3f} s, "
          f"{q.total_len} + {db.total_len} bases")
    shapes = {}
    restore = record_shapes(shapes)
    try:
        zero_counts()
        t1 = time.perf_counter()
        eng = TorchEngine(db, Config(), device="cuda")
        t2 = time.perf_counter()
        res = eng.compare(q)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        compare_launches = read_counts()
        torch.cuda.reset_peak_memory_stats()
        t4 = time.perf_counter()
        report = eng.render_report(q, res)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        launches = read_counts()
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"long20k: engine init {t2 - t1:.3f} s, compare {t3 - t2:.3f} s, "
          f"accepted {res.accepted}, candidates {res.n_candidates}, "
          f"nw_cells {res.nw_cells}, launches {compare_launches}")
    print(f"long20k render: {t5 - t4:.3f} s, {len(res.records)} records, "
          f"report {len(report)} B, sha256 "
          f"{hashlib.sha256(report).hexdigest()}, peak device memory "
          f"{peak:.2f} GiB, launches (compare and render) {launches}")
    print("long20k phases: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(res.timings.items())}))
    print("long20k stages: " + json.dumps(eng.stage_stats))
    keep["long20k"] = dict(q=q, eng=eng, res=res, perm=perm,
                           stages=dict(eng.stage_stats))
    print_shapes("long20k", shapes)
    assert_checked(shapes, cases)
    res_w, t_c = warm("long20k compare", lambda: eng.compare(q))
    report_w, t_r = warm("long20k render",
                         lambda: eng.render_report(q, res_w))
    print(f"long20k warm (profiled): compare {t_c:.3f} s, render {t_r:.3f} s")
    # once more with the plain traceback beside the kernel on the first
    # chunk of each bucket (the chains are made anew)
    for rec in res_w.records:
        rec.chain = None
    checked = []
    restore = checked_traceback(checked)
    try:
        report_c = eng.render_report(q, res_w)
    finally:
        restore()
    print("long20k render chains equal the plain traceback's on the first "
          "chunk of each bucket, (L, B, max(n_steps)): " + json.dumps(checked))
    nm = len(qr) // 2
    own = [perm[s] == r and r < nm for r, s in res.pairs]
    print(f"long20k: {sum(own)} accepted pairs are a query read and its copy")
    if res.accepted != nm or not all(own) or res_w.pairs != res.pairs:
        missing = sorted(set(range(nm)) - {r for r, _ in res.pairs})[:20]
        raise AssertionError(
            f"long20k accepted {res.accepted} != {nm} own copies; "
            f"first missing query reads {missing}"
        )
    if len(res.records) != nm or report_w != report or report_c != report:
        raise AssertionError(f"long20k render: {len(res.records)} records, "
                             "or the renders' reports differ")
    if sorted(c[0] for c in checked) != sorted(
            {Lb for Lb, _ in shapes["nw_forward"]}):
        raise AssertionError(f"long20k render: chains held at {checked}, "
                             f"F launched at {shapes['nw_forward']}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    check_render_launches("long20k", launches)
    return launches


def write_sweep_samples(directory: Path, n: int) -> list:
    """bench.py sweep_bench's samples, written as FASTA (one line a read):
    s0 is the query of synth_pair(n, 250, 0.5, seed=12345); s1-s3 are
    n // 2 copies of its first reads with 4% substitutions and random
    reads, shuffled (numpy default_rng(777)).  Returns list_samples."""
    base = synth_pair(n, 250, 0.5, seed=12345)[0]
    chars = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(777)
    n, read_len = base.shape
    directory.mkdir(parents=True)
    for s in range(4):
        if s == 0:
            mat = base
        else:
            nm = n // 2
            mut = base[:nm].copy()
            mask = rng.random(mut.shape) < 0.04
            mut[mask] = (
                mut[mask] + rng.integers(1, 4, int(mask.sum()), dtype=np.uint8)
            ) % 4
            mat = np.concatenate(
                [mut, rng.integers(0, 4, (n - nm, read_len), dtype=np.uint8)]
            )
            mat = mat[rng.permutation(n)]
        with open(directory / f"s{s}.fasta", "wb") as f:
            for i in range(n):
                f.write(b">r%d\n" % i)
                f.write(chars[mat[i]].tobytes())
                f.write(b"\n")
    return list_samples(str(directory), "fasta")


def write_rc_samples(directory: Path, n: int) -> list:
    """Four related samples of n reads of 250 bp (random.Random(2718);
    tests/util_synth.py): read i is a mutated copy (4% substitutions, 1%
    indels) of base read i in every sample when i % 3 == 0, a forward copy
    in even samples and a reverse-complemented one in odd samples when
    i % 3 == 1, and a random read otherwise.  Returns list_samples."""
    rng = random.Random(2718)
    comp = str.maketrans("ACGT", "TGCA")
    base = [random_read(rng, 250) for _ in range(n)]
    directory.mkdir(parents=True)
    for s in range(4):
        reads = []
        for i, r in enumerate(base):
            m = mutate(rng, r, sub_rate=0.04, indel_rate=0.01)
            if i % 3 == 0 or (i % 3 == 1 and s % 2 == 0):
                reads.append(m)
            elif i % 3 == 1:
                reads.append(m.translate(comp)[::-1])
            else:
                reads.append(random_read(rng, 250))
        write_fasta(directory / f"s{s}.fasta", reads, prefix=f"s{s}r")
    return list_samples(str(directory), "fasta")


def report_digests(out: Path, names) -> dict:
    """{job: (accepted, sha256 of its report)} of a sweep's outdir."""
    return {
        name: (json.loads((out / f"{name}.json").read_text())["accepted"],
               hashlib.sha256((out / name).read_bytes()).hexdigest())
        for name in names
    }


def serial_check(samples, out: Path, stats: dict) -> None:
    """Each job again on its own: a serial TorchEngine compare and
    render_report (one engine per db sample and strand, the db through
    revcomp_fasta_bytes for .r jobs, as the sweep builds it); its report
    must equal the sweep's file byte for byte.  Prints each job's compare
    and render walls."""
    engines = {}
    for job in make_jobs(samples):
        key = (job.dbname, job.reverse)
        if key not in engines:
            t0 = time.perf_counter()
            if job.reverse:
                db = parse_fasta_bytes(revcomp_fasta_bytes(job.dbpath.read_bytes()))
            else:
                db = read_fasta(str(job.dbpath))
            engines[key] = TorchEngine(db, Config(), device="cuda")
            torch.cuda.synchronize()
            print(f"serial engine {job.dbname}{'.r' if job.reverse else ''}: "
                  f"{time.perf_counter() - t0:.3f} s")
        eng = engines[key]
        q = read_fasta(str(job.qpath))
        t0 = time.perf_counter()
        res = eng.compare(q)
        t1 = time.perf_counter()
        report = eng.render_report(q, res)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"serial {job.out_name}: compare {t1 - t0:.3f} s, render "
              f"{t2 - t1:.3f} s, accepted {res.accepted}")
        if res.accepted != stats[job.out_name]["accepted"] or \
                report != (out / job.out_name).read_bytes():
            raise AssertionError(f"sweep report {job.out_name} differs from "
                                 "the serial engine's")


def run_distributed(samples_dir: Path, out: Path, nproc: int = 2) -> list:
    """nproc processes of the port's orchestrator with --distributed (gloo
    on localhost, every engine on the one card); returns their tallies."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parent)
    procs = []
    for pid in range(nproc):
        env = dict(os.environ, IMSAME_COORDINATOR=f"127.0.0.1:{port}",
                   IMSAME_NUM_PROCESSES=str(nproc),
                   IMSAME_PROCESS_ID=str(pid),
                   PYTHONPATH=root + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "imsame_tpu_torch.orchestrator",
             str(samples_dir), "0.5", "0.5", "1", "fasta", str(out),
             "--distributed"],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        ))
    tallies = []
    try:
        for pid, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=SUBPROCESS_TIMEOUT)
            if p.returncode:
                raise RuntimeError(f"process {pid} of the distributed sweep "
                                   f"exited {p.returncode}:\n{stderr[-4000:]}")
            tallies += [int(line.split(":")[1].split("(")[0])
                        for line in stdout.splitlines()
                        if "Distributed sweep total accepted" in line]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return tallies


def phase_sweep() -> dict:
    """The all-vs-all sweep, its serial check, resume, the JAX anchors (2k
    in one process and in two, and the reverse-complement samples), and a
    traced pass."""
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        t0 = time.perf_counter()
        samples = write_sweep_samples(td / "s20k", SWEEP_READS)
        print(f"sweep: data {time.perf_counter() - t0:.3f} s, 4 samples of "
              f"{SWEEP_READS} reads")
        out = td / "out"
        zero_counts()
        t0 = time.perf_counter()
        runner = AllVsAllRunner(str(out), Config(), device="cuda")
        stats = runner.run(samples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        n_pairs = len(samples) * (len(samples) - 1) // 2
        job_s = sum(e["seconds"] for e in stats.values())
        print(f"sweep: {len(stats)} jobs, wall {wall:.3f} s, "
              f"{3600 * n_pairs / wall:.1f} sample pairs/hour, sum of job "
              f"seconds {job_s:.3f} s, launches {launches}")
        for name, e in sorted(stats.items()):
            print(f"sweep {name}: accepted {e['accepted']}, seconds "
                  f"{e['seconds']:.3f}, candidates {e['candidates']}")
        if len(stats) != 2 * n_pairs or runner.failures:
            raise AssertionError(f"sweep: {len(stats)} jobs, failures "
                                 f"{runner.failures}")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel was not launched: {launches}")
        check_render_launches("sweep", launches)

        serial_check(samples, out, stats)

        again = AllVsAllRunner(str(out), Config(), device="cuda")
        if again.run(samples) != stats or len(again._engines):
            raise AssertionError("the resumed sweep built an engine or "
                                 "returned other stats")
        print("sweep resume: no engine built, same stats")

        samples_2k = write_sweep_samples(td / "s2k", 2000)
        t0 = time.perf_counter()
        r2k = AllVsAllRunner(str(td / "out2k"), Config(), device="cuda")
        r2k.run(samples_2k)
        print(f"sweep 2k: wall {time.perf_counter() - t0:.3f} s")
        got = report_digests(td / "out2k", REF_SWEEP_2K)
        if r2k.failures or got != REF_SWEEP_2K:
            raise AssertionError(f"2k sweep differs from the JAX sweep's: "
                                 f"{got}, failures {r2k.failures}")
        print("sweep 2k: 12 accepted counts and report hashes equal the "
              "JAX sweep's")

        samples_rc = write_rc_samples(td / "src", RC_READS)
        rrc = AllVsAllRunner(str(td / "out_rc"), Config(), device="cuda")
        rrc.run(samples_rc)
        got = report_digests(td / "out_rc", REF_SWEEP_RC)
        if rrc.failures or got != REF_SWEEP_RC:
            raise AssertionError(f"reverse-complement sweep differs from the "
                                 f"JAX sweep's: {got}, failures {rrc.failures}")
        print(f"sweep rc: 12 accepted counts and report hashes equal the JAX "
              f"sweep's, .r jobs accepting "
              f"{sorted(a for k, (a, _) in got.items() if '.r.' in k)}")

        t0 = time.perf_counter()
        tallies = run_distributed(td / "s2k", td / "out2k_dist")
        want = sum(a for a, _ in REF_SWEEP_2K.values())
        got = report_digests(td / "out2k_dist", REF_SWEEP_2K)
        print(f"sweep 2k, two processes: {time.perf_counter() - t0:.3f} s, "
              f"tallies {tallies}")
        if got != REF_SWEEP_2K or tallies != [want, want]:
            raise AssertionError(f"two-process sweep: {got}, tallies "
                                 f"{tallies}, want {want}")

        traced = AllVsAllRunner(str(td / "out_traced"), Config(),
                                device="cuda")
        again, _ = warm("sweep", lambda: traced.run(samples))
        if traced.failures or len(again) != 2 * n_pairs:
            raise AssertionError(f"traced sweep: {len(again)} jobs, failures "
                                 f"{traced.failures}")
    return launches


def check_anchor(label: str, res, report: bytes, want: tuple) -> None:
    """The accepted count and report sha256 must equal the JAX engine's
    `want` (accepted, sha256)."""
    sha = hashlib.sha256(report).hexdigest()
    print(f"{label}: accepted {res.accepted}, report sha256 {sha}")
    if (res.accepted, sha) != tuple(want):
        raise AssertionError(f"{label}: report differs from the JAX "
                             f"engine's {want}")


def wide_part(label: str, db: SeqInfo, q: SeqInfo, check, anchors=()) -> dict:
    """One part of phase 8: builds TorchEngine(db, Config(WIDE_CONFIG)) on
    the card, compares and renders q (prints the walls, candidates,
    phases, stages and launches, then check(engine, result, report)
    asserts), runs that compare and render once more traced by the
    profiler, and holds each of `anchors`, (SeqInfo, (accepted, report
    sha256)), to the JAX engine's result.  Returns the first run's
    launches and the engine's index."""
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    eng = TorchEngine(db, Config(**WIDE_CONFIG), device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = eng.compare(q)
    t2 = time.perf_counter()
    report = eng.render_report(q, res)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = read_counts()
    print(f"{label}: engine build {t1 - t0:.3f} s, index entries "
          f"{eng.index.n_entries}, packed index {eng._packed_idx}, "
          f"{q.n_seqs} query reads x {db.n_seqs} db reads, compare "
          f"{t2 - t1:.3f} s, render {t3 - t2:.3f} s, accepted "
          f"{res.accepted}, candidates {res.n_candidates}, nw_cells "
          f"{res.nw_cells}, report {len(report)} B, launches {launches}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    print(f"{label} phases: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(res.timings.items())}))
    counts = dict(eng.timer.counts())
    print(f"{label} stages: " + json.dumps(eng.stage_stats) + ", rung reads "
          f"{counts.get('gate_rung_reads', 0)}, resolved "
          f"{counts.get('gate_rung_resolved', 0)}")
    check(eng, res, report)
    if min(launches.values()) < 1:
        raise AssertionError(f"{label}: a kernel was not launched: {launches}")
    check_render_launches(label, launches)
    res_w, t_c = warm(f"{label} compare", lambda: eng.compare(q))
    report_w, t_r = warm(f"{label} render", lambda: eng.render_report(q, res_w))
    print(f"{label} warm (profiled): compare {t_c:.3f} s, render {t_r:.3f} s")
    if report_w != report:
        raise AssertionError(f"{label}: a second compare gave another report")
    for qa, want in anchors:
        ra = eng.compare(qa)
        check_anchor(f"{label} {qa.n_seqs} x {db.n_seqs}", ra,
                     eng.render_report(qa, ra), want)
    return launches, eng.index


def phase_wide(work: dict) -> dict:
    """Config-3's workload at N_WIDE reads a side, past the packed formats'
    2^20 reads: (a) the whole db side as the database (the wide index)
    against the first query slice of config-3's 100,000 reads, and the
    first 2,000 query reads against the JAX anchor; (b) the whole query
    side (the wide candidate format) against the first 2,000 db reads,
    against the JAX anchor.  Leaves the samples and (a)'s index in
    work["wide"] for phase 10."""
    t0 = time.perf_counter()
    qc, dbc = synth_config3(N_WIDE, *CONFIG3_SHAPE)
    q, db = reads_to_seqinfo(qc), reads_to_seqinfo(dbc)
    del qc, dbc
    print(f"wide: data {time.perf_counter() - t0:.3f} s, {q.total_len} + "
          f"{db.total_len} bases")

    def wide_db(eng, res, report):
        if eng._packed_idx or eng.index.packed is not None:
            raise AssertionError("wide-db: the engine kept the packed index")
        if res.accepted < WIDE_SLICE_MIN_ACCEPTED:
            raise AssertionError(f"wide-db: accepted {res.accepted} < "
                                 f"{WIDE_SLICE_MIN_ACCEPTED}")

    def wide_query(eng, res, report):
        if res.n_query < PACKED_MAX_READS:
            raise AssertionError("wide-query: the query is under 2^20 reads")
        check_anchor("wide-query", res, report, REF_WIDE_QUERY)

    la, index = wide_part("wide-db", db, q.slice_reads(0, CONFIG3_SLICE),
                          wide_db, [(q.slice_reads(0, 2000), REF_WIDE_DB_2K)])
    torch.cuda.empty_cache()
    lb, _ = wide_part("wide-query", db.slice_reads(0, 2000), q, wide_query)
    work["wide"] = dict(q=q, db=db, index=index)
    return {k: la[k] + lb[k] for k in la}


ENUM_PHASES = ("gate.build", "gate.enum", "gate.dispatch", "gate.fetch",
               "resolve.extend", "host.gc", "host.cpu")


def enum_engine(host: TorchEngine) -> TorchEngine:
    """An engine with device candidate enumeration on a host-gate
    engine's database and index."""
    eng = TorchEngine(host.db, Config(gate_enum=True), index=host.index,
                      device="cuda")
    if not eng._use_enum:
        raise AssertionError("the enumerating engine took the host gate")
    return eng


GC_SECONDS = [0.0, 0.0]  # [seconds in the cyclic collector, last start]


def gc_clock(phase: str, info: dict) -> None:
    """A gc.callbacks entry: sums the collector's pauses into
    GC_SECONDS[0]."""
    if phase == "start":
        GC_SECONDS[1] = time.perf_counter()
    else:
        GC_SECONDS[0] += time.perf_counter() - GC_SECONDS[1]


def timed_compare(eng: TorchEngine, q: SeqInfo):
    """(result, wall s, this compare's phase seconds, peak device GiB) of
    one compare: the engine's phase timer sums over its compares.  The
    phases also hold host.gc (the cyclic collector's pauses, gc_clock)
    and host.cpu (the process's CPU seconds, every thread)."""
    before = dict(eng.timer.items())
    gc0, cpu0 = GC_SECONDS[0], time.process_time()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = eng.compare(q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phases = {k: v - before.get(k, 0.0) for k, v in eng.timer.items()}
    phases["host.gc"] = GC_SECONDS[0] - gc0
    phases["host.cpu"] = time.process_time() - cpu0
    return res, wall, phases, torch.cuda.max_memory_allocated() / 2**30


def print_run(label: str, res, wall: float, phases: dict, peak: float):
    print(f"{label}: compare {wall:.3f} s, accepted {res.accepted}, "
          f"candidates {res.n_candidates}, peak device memory {peak:.2f} GiB"
          ", " + ", ".join(f"{k} {phases.get(k, 0.0):.4f}"
                           for k in ENUM_PHASES))


def same_as_host(label: str, res, eng, want) -> None:
    """The enumerating compare's pairs, candidates, NW cells and stage
    stats must equal the host-gate compare's (want: its result and
    stages)."""
    hres, stages = want["res"], want["stages"]
    got = (res.pairs == hres.pairs, res.n_candidates == hres.n_candidates,
           res.nw_cells == hres.nw_cells, eng.stage_stats == stages)
    print(f"{label}: pairs, candidates, nw_cells and stages equal the host "
          f"gate's: {all(got)} ({res.n_candidates} candidates, stages "
          + json.dumps(eng.stage_stats) + ")")
    if not all(got):
        raise AssertionError(f"{label}: differs from the host gate {got}")


def ab_runs(label: str, host: TorchEngine, eng: TorchEngine, q: SeqInfo):
    """Warm compares in turns (host, enum, enum, host); prints each run's
    wall, gate phases and peak device memory, and the means."""
    walls = {"host": [], "enum": []}
    for who, e in (("host", host), ("enum", eng), ("enum", eng),
                   ("host", host)):
        res, wall, phases, peak = timed_compare(e, q)
        walls[who].append(wall)
        print_run(f"ab {label} {who}", res, wall, phases, peak)
        print(f"ab {label} {who} phases: " + json.dumps(
            {k: round(v, 4) for k, v in sorted(phases.items())}))
    h, e = (sum(walls[k]) / len(walls[k]) for k in ("host", "enum"))
    print(f"ab {label}: host {h:.3f} s, enum {e:.3f} s, enum/host "
          f"{e / h:.3f}")


def triples_check(eng: TorchEngine, q: SeqInfo) -> None:
    """On the card: enum_candidates over stage 2's whole rank window
    [F, N_r) of every read equals the host build_flat's triples."""
    stream = eng._kmer_stream(q)
    C_off = stream[5]
    N_r = C_off[1:] - C_off[:-1]
    F = eng.first_window()
    reads = np.flatnonzero(N_r > F)
    frm = np.zeros(q.n_seqs, np.int64)
    to = np.zeros(q.n_seqs, np.int64)
    frm[reads], to[reads] = F, N_r[reads]
    host = build_flat(stream, q.start.astype(np.int64), reads, frm[reads],
                      to[reads])
    N = len(host[0])
    dev = eng._last_dev
    lo_g, cnt_g, Rcum, d_hasb = eng._enum_prepare(q, dev)
    scum, start_off = enum_gate.enum_select_prefix(
        cnt_g, Rcum, *to_cuda(frm.astype(np.int32), to.astype(np.int32)))
    got = enum_gate.enum_candidates(
        lo_g, scum, start_off, d_hasb, 0, chunk=-(-N // 32) * 32,
        row_len=dev[0].shape[1] * 16)
    same = all(np.array_equal(g[:N].cpu().numpy(), h)
               for g, h in zip(got, host))
    print(f"enum 20k triples: {N} candidates of stage 2's window [{F}, N_r)"
          f" of {len(reads)} reads, on the card equal to build_flat's: {same}")
    if not same:
        raise AssertionError("enum_candidates differs from build_flat")


def phase_enum(cases: list, keep: dict) -> dict:
    """Device candidate enumeration, Config(gate_enum=True), on the
    workloads of phases 4-6 with their host-gate engines' indexes: the
    same results as the host gate (and the JAX hashes), the candidate
    triples on the card, then host and enumeration in turns on warm
    engines, and a traced run of each enumerated compare."""
    launches = dict.fromkeys(COUNTED, 0)

    def count():
        for k, v in read_counts().items():
            launches[k] += v

    # 20k x 20k, and its 2k report; each workload leaves keep once used,
    # so a later one's peak device memory counts no earlier engine
    w = keep.pop("20k")
    q, host = w["q"], w["eng"]
    eng = enum_engine(host)
    zero_counts()
    res, wall, phases, peak = timed_compare(eng, q)
    count()
    print_run("enum 20k", res, wall, phases, peak)
    same_as_host("enum 20k", res, eng, w)
    if res.accepted != ACCEPTED_20K:
        raise AssertionError(f"enum 20k accepted {res.accepted}")
    triples_check(eng, q)
    zero_counts()
    res2 = eng.compare(w["q2"])
    sha = hashlib.sha256(eng.render_report(w["q2"], res2)).hexdigest()
    count()
    print(f"enum 2k: accepted {res2.accepted}, report sha256 {sha}")
    if res2.accepted != REF_2K_ACCEPTED or sha != REF_2K_SHA256:
        raise AssertionError("enum 2k report differs from the JAX engine's")
    ab_runs("20k", host, eng, q)
    warm("enum 20k compare", lambda: eng.compare(q))

    # the long 512 block, compare and render
    w = keep.pop("long")
    q, host = w["q"], w["eng"]
    eng = enum_engine(host)
    shapes = {}
    restore = record_shapes(shapes)
    try:
        zero_counts()
        res, wall, phases, peak = timed_compare(eng, q)
        report = eng.render_report(q, res)
        count()
    finally:
        restore()
    sha = hashlib.sha256(report).hexdigest()
    print_run("enum long", res, wall, phases, peak)
    print(f"enum long: accepted {res.accepted}, report sha256 {sha}")
    same_as_host("enum long", res, eng, w)
    assert_checked(shapes, cases)
    if res.accepted != REF_LONG_ACCEPTED or sha != REF_LONG_SHA256:
        raise AssertionError("enum long report differs from the JAX engine's")
    warm("enum long compare", lambda: eng.compare(q))

    # the long 20k compare
    w = keep.pop("long20k")
    q, host, perm = w["q"], w["eng"], w["perm"]
    eng = enum_engine(host)
    shapes = {}
    restore = record_shapes(shapes)
    try:
        zero_counts()
        res, wall, phases, peak = timed_compare(eng, q)
        count()
    finally:
        restore()
    print_run("enum long20k", res, wall, phases, peak)
    same_as_host("enum long20k", res, eng, w)
    assert_checked(shapes, cases)
    nm = q.n_seqs // 2
    own = sum(perm[s] == r and r < nm for r, s in res.pairs)
    print(f"enum long20k: {own} accepted pairs are a query read and its copy")
    if res.accepted != nm or own != nm:
        raise AssertionError(f"enum long20k accepted {res.accepted}, {own} "
                             "own copies")
    ab_runs("long20k", host, eng, q)
    warm("enum long20k compare", lambda: eng.compare(q))
    print("enum wide-db, wide-query: skipped: enumeration needs the packed "
          "index (wide-db has the wide one) and at most ENUM_MAX_ROWS "
          "padded query rows (wide-query has 2^21)")
    print(f"enum launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    check_render_launches("enum", launches)
    return launches


MESH_DEVICES = ["cuda:0"] * 4  # phase 10's positions, all on one card


def mesh_engine(db: SeqInfo, grid, index=None, **cfg) -> TorchEngine:
    """TorchEngine(db, Config(mesh_shape=grid, **cfg)) on MESH_DEVICES,
    on `index` when given; prints its build wall."""
    t0 = time.perf_counter()
    eng = TorchEngine(db, Config(mesh_shape=grid, **cfg), index=index,
                      device="cuda", mesh_devices=MESH_DEVICES)
    torch.cuda.synchronize()
    if eng._mesh is None or (eng._mesh.shape["data"],
                             eng._mesh.shape["dict"]) != tuple(grid):
        raise AssertionError(f"mesh {grid}: the engine has no such grid")
    print(f"mesh {tuple(grid)} engine build {time.perf_counter() - t0:.3f} s"
          f", index entries {eng.index.n_entries}, shard rows "
          f"{eng._shard_rows}")
    return eng


def mesh_run(label: str, eng: TorchEngine, q: SeqInfo, launches: dict,
             render: bool = True):
    """One cold compare (and render) on a mesh engine, its kernel launches
    added to `launches`; prints the walls, counts, peak device memory and
    launches.  Returns (result, report or None)."""
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = eng.compare(q)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    report = eng.render_report(q, res) if render else None
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = read_counts()
    for k, v in n.items():
        launches[k] += v
    check_render_launches(label, n)
    print(f"{label}: compare {t1 - t0:.3f} s, render {t2 - t1:.3f} s, "
          f"accepted {res.accepted}, candidates {res.n_candidates}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB, launches {n}, stages " + json.dumps(eng.stage_stats))
    return res, report


def same_result(label: str, res, report, want: dict) -> None:
    """The pairs (and the report, when given) must equal the one-device
    engine's (want: its result and report)."""
    same = res.pairs == want["res"].pairs and (
        report is None or report == want["report"])
    print(f"{label}: pairs{'' if report is None else ' and report'} equal "
          f"the one-device engine's: {same}")
    if not same:
        raise AssertionError(f"{label}: differs from the one-device engine")


def phase_mesh(cases: list, work: dict) -> dict:
    """Phase 10: one engine over a grid of mesh positions
    (Config.mesh_shape, TorchEngine(mesh_devices=)), here four positions
    on the one card (MESH_DEVICES): every sharding rule and both kernels
    at per-position batch shapes, but sharding overhead on one card, not
    a multi-card speedup.  The 20k (phase 4) at (4, 1), (2, 2) and (1, 4),
    each with phase 4's pairs and report, the 2k's JAX hash at (2, 2) and
    a traced warm compare at (2, 2); the long 512 block (phase 5) at (2,
    2) and (1, 4), its JAX hash; phase 8's 2,000 queries against the wide
    db at (1, 4) on phase 8's index, its JAX hash; the wide query at (2,
    2), its JAX hash; Config(gate_enum=True) at (2, 2), the host gate's
    pairs.  With two cards or more, also the 20k on "auto" over them and
    a compare on device "cuda:1"."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(COUNTED, 0)
    shapes = {}
    restore = record_shapes(shapes)
    try:
        w = w20 = work.pop("20k")
        for grid in ((4, 1), (2, 2), (1, 4)):
            eng = mesh_engine(w["db"], grid, index=w["index"])
            res, report = mesh_run(f"mesh 20k {grid}", eng, w["q"], launches)
            same_result(f"mesh 20k {grid}", res, report, w)
            if grid == (2, 2):
                ra, rep2 = mesh_run(f"mesh 2k {grid}", eng, w["q2"], launches)
                check_anchor(f"mesh 2k {grid}", ra, rep2,
                             (REF_2K_ACCEPTED, REF_2K_SHA256))
                _, t_c = warm(f"mesh 20k {grid} compare",
                              lambda: eng.compare(w["q"]))
                print(f"mesh 20k {grid} warm (profiled): compare {t_c:.3f} s")
            del eng
        eng = mesh_engine(w["db"], (2, 2), index=w["index"], gate_enum=True)
        if eng._use_enum:
            raise AssertionError("mesh enum: a mesh engine enumerated")
        res, _ = mesh_run("mesh enum 20k (2, 2)", eng, w["q"], launches,
                          render=False)
        same_result("mesh enum 20k (2, 2)", res, None, w)
        del eng

        w = work.pop("long")
        for grid in ((2, 2), (1, 4)):
            eng = mesh_engine(w["db"], grid)
            res, report = mesh_run(f"mesh long {grid}", eng, w["q"], launches)
            check_anchor(f"mesh long {grid}", res, report,
                         (REF_LONG_ACCEPTED, REF_LONG_SHA256))
            del eng

        # dryrun_multichip's 8 positions on the visible cards, a (4, 2)
        # grid: its pairs and report equal its one-device engine's
        zero_counts()
        dryrun.dryrun_multichip(8)
        n = read_counts()
        check_render_launches("mesh dryrun (4, 2)", n)
        print(f"mesh dryrun (4, 2): launches {n}")
        for k, v in n.items():
            launches[k] += v

        w = work.pop("wide")
        torch.cuda.empty_cache()
        eng = mesh_engine(w["db"], (1, 4), index=w["index"], **WIDE_CONFIG)
        if eng._packed_idx:
            raise AssertionError("mesh wide-db: the engine kept the packed "
                                 "index")
        q2 = w["q"].slice_reads(0, 2000)
        res, report = mesh_run("mesh wide-db 2000 (1, 4)", eng, q2, launches)
        check_anchor("mesh wide-db 2000 (1, 4)", res, report, REF_WIDE_DB_2K)
        del eng, w["index"]
        torch.cuda.empty_cache()
        eng = mesh_engine(w["db"].slice_reads(0, 2000), (2, 2), **WIDE_CONFIG)
        res, report = mesh_run("mesh wide-query (2, 2)", eng, w["q"],
                               launches)
        check_anchor("mesh wide-query (2, 2)", res, report, REF_WIDE_QUERY)
        del eng
    finally:
        restore()
    print_shapes("mesh", shapes)
    assert_checked(shapes, cases)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        # real cards: "auto" spreads the 20k over them; one engine on the
        # second card alone (kernels launched on a card other than the
        # current one)
        w = w20
        eng = TorchEngine(w["db"], Config(), index=w["index"], device="cuda")
        if eng._mesh is None:
            raise AssertionError(f"auto took one device of {n_cards}")
        print(f"mesh auto: {eng._mesh.shape} over {n_cards} cards")
        res, report = mesh_run("mesh auto 20k", eng, w["q"], launches)
        same_result("mesh auto 20k", res, report, w)
        del eng
        eng = TorchEngine(w["db"], Config(mesh_shape=None), index=w["index"],
                          device="cuda:1")
        ra, rep2 = mesh_run("cuda:1 2k", eng, w["q2"], launches)
        check_anchor("cuda:1 2k", ra, rep2, (REF_2K_ACCEPTED, REF_2K_SHA256))
        del eng
    else:
        print(f"mesh real cards: not run: the 20k on \"auto\" over several "
              f"cards and a compare on cuda:1 need two cards; this machine "
              f"has {n_cards}")
    print(f"mesh launches {launches}, phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    check_render_launches("mesh", launches)
    return launches


def phase_100k(cases: list) -> dict:
    """Phase 11: bench.py large_bench's 100k x 100k workload through a new
    engine: the index build, a cold compare and a cold render, timed;
    must accept ACCEPTED_100K reads, and the first 2,000 query reads
    against the same database must give the JAX engine's count and report
    hash (REF_100K_2K).  Prints the walls, query reads/s, the report's
    bytes and sha256, the phases and stages, peak device memory, the
    kernels' batch shapes and a traced warm compare."""
    qc, dbc = synth_pair(N_100K, 250, 0.5, seed=12345)
    q, db = reads_to_seqinfo(qc), reads_to_seqinfo(dbc)
    shapes = {}
    restore = record_shapes(shapes)
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        eng = TorchEngine(db, Config(), device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = eng.compare(q)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        report = eng.render_report(q, res)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = read_counts()
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"100k: index build {t1 - t0:.3f} s ({eng.index.n_entries} "
          f"entries), compare {t2 - t1:.3f} s "
          f"({N_100K / (t2 - t1):.1f} query reads/s), render {t3 - t2:.3f} "
          f"s, accepted {res.accepted}, candidates {res.n_candidates}, "
          f"nw_cells {res.nw_cells}, report {len(report)} B, sha256 "
          f"{hashlib.sha256(report).hexdigest()}, peak device memory "
          f"{peak:.2f} GiB, launches {launches}")
    print("100k phases: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(res.timings.items())}))
    print("100k stages: " + json.dumps(eng.stage_stats))
    print_shapes("100k", shapes)
    assert_checked(shapes, cases)
    if res.accepted != ACCEPTED_100K:
        raise AssertionError(f"100k accepted {res.accepted} != "
                             f"{ACCEPTED_100K}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    check_render_launches("100k", launches)
    res_w, t_c = warm("100k compare", lambda: eng.compare(q))
    print(f"100k warm (profiled): compare {t_c:.3f} s")
    if res_w.pairs != res.pairs:
        raise AssertionError("a second 100k compare gave other pairs")
    q2 = reads_to_seqinfo(qc[:2000])
    res2 = eng.compare(q2)
    check_anchor("100k 2k", res2, eng.render_report(q2, res2), REF_100K_2K)
    return launches


def phase_config3(gate_enum: bool = False) -> dict:
    """bench_config3.py's workload whole through the port: 1M x 1M reads
    of 250 bp written as FASTA and read back by the streaming reader
    (io/fasta.py read_fasta_stream, in 64 MiB chunks), the engine on the
    db side, the query in 10 slices of 100,000 reads, slice 0 rendered
    (config3_align).  With gate_enum an engine with device candidate
    enumeration on the same index then aligns the same slices, and its
    align time and phase sums print beside the host gate's.  Then slices
    0 and 9 run once more, traced by the profiler (on the enumerating
    engine with gate_enum)."""
    n = CONFIG3_READS
    out = {}
    t_all = time.perf_counter()
    qm, dm = synth_config3(n, *CONFIG3_SHAPE)
    chars = np.frombuffer(b"ACGT", np.uint8)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        for name, mat in (("q.fa", qm), ("db.fa", dm)):
            write_fasta(Path(td) / name,
                        (chars[r].tobytes().decode() for r in mat))
        out["fasta_write_seconds"] = time.perf_counter() - t0
        out["fasta_bytes_per_side"] = (Path(td) / "q.fa").stat().st_size
        del qm, dm
        # 259.9 MB a side, under read_fasta's 256 MiB streaming threshold:
        # the streaming reader is called by name
        t0 = time.perf_counter()
        q = read_fasta_stream(str(Path(td) / "q.fa"))
        db = read_fasta_stream(str(Path(td) / "db.fa"))
        out["ingest_seconds"] = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    eng = TorchEngine(db, Config(**WIDE_CONFIG), device="cuda")
    torch.cuda.synchronize()
    out["index_seconds"] = time.perf_counter() - t0
    out["index_entries"] = eng.index.n_entries
    out.update(config3_align("config3", eng, q))
    out["e2e_seconds"] = time.perf_counter() - t_all
    print("config3: " + json.dumps(out))
    if gate_enum:
        index = eng.index
        del eng
        torch.cuda.empty_cache()
        zero_counts()
        eng = TorchEngine(db, Config(**WIDE_CONFIG, gate_enum=True),
                          index=index, device="cuda")
        if not eng._use_enum:
            raise AssertionError("config3: the enumerating engine took the "
                                 "host gate")
        enum = config3_align("config3 enum", eng, q)
        print("config3 enum: " + json.dumps(enum))
        print(f"config3 align: host gate {out['align_seconds']:.3f} s, "
              f"enumeration {enum['align_seconds']:.3f} s, enum/host "
              f"{enum['align_seconds'] / out['align_seconds']:.3f}")
    # a slice of copies and the slice of random reads, again, traced
    for s in (0, n // CONFIG3_SLICE - 1):
        qs = q.slice_reads(s * CONFIG3_SLICE, (s + 1) * CONFIG3_SLICE)
        warm(f"config3{' enum' if gate_enum else ''} slice {s} compare",
             lambda: eng.compare(qs))
    return out


def config3_align(label: str, eng: TorchEngine, q: SeqInfo) -> dict:
    """Config-3's 10 compares of 100,000 query reads on `eng`, slice 0
    rendered; prints each slice and the engine's phase sums, and asserts
    CONFIG3.json's accepts and slice-0 report bytes and the candidates and
    NW cells recorded with the gate's rung."""
    n = q.n_seqs
    out = {}
    accepted = n_cands = nw_cells = 0
    walls = []
    t_align = time.perf_counter()
    for s in range(n // CONFIG3_SLICE):
        qs = q.slice_reads(s * CONFIG3_SLICE, (s + 1) * CONFIG3_SLICE)
        t0 = time.perf_counter()
        res = eng.compare(qs)
        walls.append(time.perf_counter() - t0)
        accepted += res.accepted
        n_cands += res.n_candidates
        nw_cells += res.nw_cells
        print(f"{label} slice {s}: compare {walls[-1]:.3f} s, accepted "
              f"{res.accepted}, candidates {res.n_candidates}, nw_cells "
              f"{res.nw_cells}, stages " + json.dumps(eng.stage_stats))
        if s == 0:
            t0 = time.perf_counter()
            out["report_bytes_slice0"] = len(eng.render_report(qs, res))
            torch.cuda.synchronize()
            out["render_slice0_seconds"] = time.perf_counter() - t0
    out["align_seconds"] = (time.perf_counter() - t_align
                            - out["render_slice0_seconds"])
    out.update(slice_walls=walls, accepted=accepted, candidates=n_cands,
               nw_cells=nw_cells, reads_per_s_align=n / out["align_seconds"],
               launches=read_counts())
    check_render_launches(label, out["launches"])
    # the engine's phase timer sums over its compares: the 10 slices
    print(f"{label} phases: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(eng.timer.items())}))
    counts = dict(eng.timer.counts())
    out.update(rung_reads=counts.get("gate_rung_reads", 0),
               rung_resolved=counts.get("gate_rung_resolved", 0))
    print(f"{label}: candidates {n_cands} (CONFIG3.json {CONFIG3_CANDIDATES})"
          f", nw_cells {nw_cells} (CONFIG3.json {CONFIG3_NW_CELLS}), rung "
          f"reads {out['rung_reads']}, resolved {out['rung_resolved']}")
    want = (CONFIG3_ACCEPTED, CONFIG3_SLICE0_BYTES, CONFIG3_RUNG_CANDIDATES,
            CONFIG3_RUNG_NW_CELLS)
    got = (accepted, out["report_bytes_slice0"], n_cands, nw_cells)
    if got != want:
        raise AssertionError(f"{label}: accepted, slice-0 report bytes, "
                             f"candidates, NW cells {got}; recorded "
                             f"{want}")
    if not (n_cands < CONFIG3_CANDIDATES and nw_cells <= CONFIG3_NW_CELLS):
        raise AssertionError(f"{label}: candidates {n_cands}, NW cells "
                             f"{nw_cells}, not below CONFIG3.json's")
    return out


def main(argv) -> int:
    gc.callbacks.append(gc_clock)
    smi = phase_device()
    phase_build()
    if argv[:1] == ["--ab"]:  # python3 chip_smoke.py --ab PARENT [OUT_DIR]
        phase_ab(*argv[1:3])
        return 0
    if argv[:1] == ["--ab-traceback"]:  # CHECKOUT [CHECKOUT ...]
        sides = {root: checkout_nw_cuda(root) for root in argv[1:]}
        for root, mod in sides.items():
            build_kernels(mod, f" of {root}")
        ab_traceback(sides)
        return 0
    if argv[:1] == ["--config3"]:  # [--gate-enum]
        count_plain_gate()
        phase_config3(gate_enum=argv[1:2] == ["--gate-enum"])
        return finish(smi)
    count_plain_gate()
    cases = phase_kernels()
    PLAIN_GATE_ON_CARD[0] = 0  # the kernels phase ran it on purpose
    keep = {}  # phases 4-6's workloads and engines, for phase 9
    paths = [phase_slice(keep), phase_long(cases, keep),
             phase_long20k(cases, keep)]
    # phases 4-5's samples and results (not their engines), for phase 10
    work = {k: {f: v for f, v in keep[k].items() if f != "eng"}
            for k in ("20k", "long")}
    work["20k"]["index"] = keep["20k"]["eng"].index
    paths.append(phase_enum(cases, keep))
    # phase 9 took the engines out of keep; phases 7-8 read their peak
    # device memory with nothing of phases 4-6 alive
    torch.cuda.empty_cache()
    paths += [phase_sweep(), phase_wide(work)]
    torch.cuda.empty_cache()
    paths.append(phase_mesh(cases, work))
    del work
    torch.cuda.empty_cache()
    paths.append(phase_100k(cases))
    kernels = []
    for name, where in REPLACES.items():
        mine = [c for c in cases if c["kernel"] == name]
        # the gate's headline case (the 20k's chunk format at its full
        # chunk), else the largest case whose plain call ran on the same
        # batch
        top = next((c for c in mine if c.get("headline")), None) or max(
            (c for c in mine
             if c["plain_ms"] is not None and c["plain_B"] >= c["B"]),
            key=lambda c: (c["L"], c["B"]))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"imsame_tpu_torch/csrc/{name}.cu",
            "replaces": ", ".join(where),
            "launches": sum(p[name] for p in paths),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            # no PyTorch call computes S, F, the traceback or the gate
            "library_ms": None,
            "library_none_because": "no PyTorch call computes it",
            "L": top["L"], "B": top["B"], "plain_B": top["plain_B"],
        })
    print(json.dumps({"kernels": kernels}))
    return finish(smi)


def finish(smi: str) -> int:
    """Prints the card's name and power limit, then the device line."""
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
