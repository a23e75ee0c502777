"""GPU smoke run of kaminpar_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build the hand-written CUDA kernels (one nvcc per source) and the
     three native host libraries (g++: ip.cpp, the initial bipartitioner,
     fm.cpp, the k-way FM, and codec.cpp + codec2.cpp, the compressed
     graphs' codecs), all at once;
  3. run every kernel at the shapes the main path gives it, hold it
     bitwise against its plain torch twin on the same CUDA tensors, and
     time kernel, twin and (where one exists) a single PyTorch library
     call; K1 and K2 are also held against their twins on edge cases (an
     odd-length index view at every offset from a 16-byte boundary, hub
     rows of 45k edges, a k beyond K2's shared-memory design, delta-round
     spans cut at the buffer), the fused K3 on cluster weights around the
     cap and at INT32_MAX, at num_slots 4 (contested rows), on hub rows
     of 45k edges and on delta spans cut at the buffer, and it is timed
     beside the torch chain it replaces (scatter_slot_ratings, then the
     standalone K3); at the dist path's shapes (shard 0 of the medium
     graph on 8 shards, the first LP round), the standalone K3 with
     `label_range=` and with `communities=` and K2 over the shard's spans
     with its owned-plus-ghost label table, each bitwise against its twin
     with rows whose winner the mask changes, and timed beside its bound;
     and the standalone K3 swept over slot tables of S = 8, 64, 128, 512,
     6 and 7 and a base off a 16-byte boundary (sweep_k3), with
     require_fit on and off, communities=, label_range=, empty rows and
     ties broken by the hash, bitwise against its twin (phase 15 sweeps
     its int64 variant);
  4. partition make_rmat(1<<14, 120_000, seed=3) at k=8 on the CPU and on
     the card: the two partitions must be bitwise equal, and both must
     have run the native initial bipartitioner;
  5. the main path, KaMinPar("default").compute_partition(k=16, eps=0.03,
     seed=1), on the bench's two graphs: make_rmat(1<<20, 10_000_000,
     seed=7) and make_rmat(1<<16, 600_000, seed=3).  Each partition must
     be in range and within the strict caps, and its device cut must equal
     a numpy recount and the cut of every earlier run; every kernel of
     the path (K1, K2, the fused K3) must have launched during the phase,
     and the native initial bipartitioner in each cell.  Every launch is
     bracketed by CUDA events, summed per kernel and cell as `path_ms`;
  7a. the slice's other paths at n = 2^14: make_rmat(1<<14, 120_000,
     seed=3) at k=8 on the CPU and on the card with the `strong` preset
     (native FM), `mtkahypar-kway` (the k-way scheme), `vcycle` and `deep`
     with four host workers: each pair of partitions bitwise equal, and
     the native FM run in both `strong` runs;
  7b. those paths at full width: `mtkahypar-kway` and `vcycle` on the
     medium graph, k=16, eps=0.03, seed=1, each checked as in phase 5,
     with its cut held against the JAX package's cut for the same graph,
     preset and seed (EXPECTED_PRESET_CUTS); the path's kernels must
     launch in each run, whose launches and `path_ms` are counted from
     zero.  `strong` runs at n = 2^14 only (7a): its single-threaded host
     FM took 143-171 s on the medium graph (pinned at 244,663 until the
     smoke made room for phase 15) and ran past 240 s on the large one
     (PERF.md);
  7c. the fused K3 with `communities=` (the v-cycle's restriction) at the
     medium level 0, the communities a 16-block partition of phase 5:
     bitwise against its twin, with rows whose best label the mask
     changes, and timed beside the call without communities;
  8a. compressed and streamed inputs at n = 2^14: make_rmat(1<<14,
     120_000, seed=3) at k=8 on the CPU and on the card with `terapart`
     and `terapart-largek` (set_graph compresses with v2, the deep scheme
     uploads chunk by chunk), `external` with 2^15-edge chunks, and
     `external` under a 3,000,000-byte budget with contraction limit 160
     (chunks halved to 2^16 edges, two streamed levels): each pair of
     partitions bitwise equal;
  8b. those paths at full width, k=16, eps=0.03, seed=1: `terapart` on the
     medium and the large graph, `external` on the large graph without a
     budget and under a 96 MiB budget, each checked as in phase 5 and its
     cut held against the JAX package's (EXPECTED_STREAM_CUTS; the
     budgeted pin was taken with the JAX memory governor off, and the
     port's budgeted external runs switch theirs off the same way).  K1 must launch inside the stream and K1 and K2
     in the in-core handoff; the stream's peak device allocation must
     stay below the fine graph's device CSR bytes, and the budgeted run
     must stream the JAX run's 7 levels.  Each run prints its compression
     ratio and set_graph time, or its per-level stream record (chunks,
     walls, overlap, bytes) and the handoff's phase walls;
  9a. graph files, overlay and noop coarsening and the warm start at
     n = 2^14, k=8: make_rmat(1<<14, 120_000, seed=3) is written as METIS,
     ParHiP and a compressed container, and each load_graph (the
     container also lazily, memory-mapped) must return the written
     arrays; overlay and noop coarsening, the `vcycle` warm start from
     phase 4's partition with max_levels 0 and 2, and `default` on each
     file's graph run on the CPU and on the card, each pair bitwise equal,
     `default` from a file giving phase 4's partition;
  9b. the same at full width, k=16, eps=0.03, seed=1: the large graph
     written as ParHiP and as a compressed container and read back
     (`default` on each), the medium graph as METIS, read by the native
     tokenizer (`default`), overlay coarsening and the warm v-cycle
     (max_levels 2, from phase 5's partition) on the medium graph, and
     `external` on the lazily loaded large container, with the stream's
     peak allocation below the fine CSR's bytes; each cut held to the
     JAX package's (EXPECTED_FILE_CUTS), the path's kernels launched in
     each run (K1 and K2 on the large graph and in the warm v-cycle,
     whose restricted LP takes sort2 in both packages, and the fused K3
     too on the medium graph's other runs), and the METIS run records
     telemetry: the run report it writes must validate against the
     port's schema, its scope walls equal `last_timings` and it must
     diff clean against itself.  Each load time and wall is
     printed with the card's name and power limit;
  10a. the resilience layer at n = 2^14, k=8, on the CPU and on the card,
     each pair bitwise equal (and with the same resilience events):
     forced rungs 1-4, an injected OOM (`device-oom:nth=1`), a
     3,000,000-byte budget, soft stops at `coarsen:1`, `initial` and
     `uncoarsen:1`, hard stops (SimulatedPreemption after the barrier's
     checkpoint) with a resume for `default` at `coarsen:1!`, `initial!`
     and `uncoarsen:1!`, for `mtkahypar-kway`, `vcycle` and `external`
     at one barrier each, RB's soft stop at `rb-toplevel`,
     `compressed-stream:nth=1` under `terapart` and
     `bit-flip:partition:nth=1` recovered by the integrity retry; the
     rung 1-2, OOM, `default` resume and bit-flip runs give phase 4's
     partition;
  10b. the medium graph, k=16: every cell of EXPECTED_RESILIENCE_CUTS
     (forced rungs 1 and 4, 24 and 16 MiB budgets, the injected OOM, a
     resume from `uncoarsen:1!`, four soft stops), each cut held to the
     JAX package's, the "= default" cells to phase 5's partition, each
     run's rung checked; K1, K2 and the fused K3 launch at rungs 1 and 2
     (K1 and K2 in the resumed run, which skips level 0's clustering,
     the only place the fused K3 runs) and K1 in rung 3's stream;
  10c. the large graph with a checkpoint directory: the bytes and
     seconds of every checkpoint write and the wall beside phase 5's,
     then a hard stop at `uncoarsen:1!` and a resume giving phase 5's
     partition;
  10d. a genuine CUDA out-of-memory error: the peak allocation of forced
     rungs 0 and 1 on the large graph (rung 1's partition held to the
     JAX package's, EXPECTED_LARGE_RUNG1), the allocator capped between them
     (`torch.cuda.set_per_process_memory_fraction`), `default` with no
     budget: rung 0 must fail for real, the ladder record it (a
     `degraded` event, `injected: false`) and finish at a higher rung
     with that rung's forced partition;
  10e. the integrity sentinels' cost: the large `default` with
     KAMINPAR_TPU_INTEGRITY=0 and with the sentinels, the same
     partition, both walls and `overhead_pct`.
  11a. dynamic sessions and the entry points at n = 2^14, k=8, on the
     CPU and on the card, each pair bitwise equal: a three-step delta
     chain (synth_chain, 1% churn, one vertex added at step 3) through
     run_chain with replicas 1 and 2 (equal chain digests and
     decisions), a step inserting 10% more edges, half of them uniform,
     which must escalate or go cold, the CLI (`python -m
     kaminpar_tpu_torch`, the card by default) against the CLI with
     `--device cpu` and phase 4's partition, the C ABI (the smoke's C
     program linked to libckaminpar_tpu_torch.so, KAMINPAR_TPU_PLATFORM
     unset) against phase 4's partition, and `tools components`;
  11b. bench.py's dynamic measurement on the medium graph: phase 5's
     partition committed to a session (its digest and the chain's
     pinned), four synth_chain(seed=41, edge_churn=0.01) steps, each
     applied in place, repartitioned warm and followed by a cold twin
     (`default` on the mutated graph), every mode, drift, cut, partition
     digest, chain digest and twin cut held to EXPECTED_DYNAMIC; then
     the same chain with replicas 2 held to EXPECTED_DYNAMIC_REPLICAS.
     A warm step must launch K1 and K2 (its restricted LP takes sort2,
     never the fused K3), a cold twin all three; prints the walls, the
     warm speedup (mean cold twin wall over mean warm wall) and the
     largest fractional cut gap;
  11d. the CLI on the card in a subprocess: the medium spec written to
     phase 5's partition (RESULT cut 250,236), its walls (interpreter
     start and imports, CUDA context, kernel loading, io, partitioning),
     and `--delta-batch` on 11b's four batches giving the JAX CLI's
     final partition (EXPECTED_CLI_CHAIN); the CLI's main in this
     process counts its launches;
  11e. the C ABI on the card: examples/c_api.c compiled unchanged and
     run, the C program partitioning the medium CSR from a second thread
     (cut 250,236, phase 5's partition), and kmp_compute_partition
     called in this process through ctypes for its launch counts.
  12a. the distributed partitioner at n = 2^14, k=8, on the CPU and on
     the card, each pair bitwise equal: kp.parallel.dKaMinPar("default")
     on D = 1, 2 and 8 shards and on a (2, 4) grid, `lp_rating="scatter"`
     and local-lp clustering with it (D = 8), the forced sharded
     contraction; `strong` (Jet), `cluster-balancer` and HEM + LP
     clustering at n = 2^12 and `colored-lp` on a 64x64 grid, on 2
     shards; then on the card a hard
     stop at dist-uncoarsen:0 (D = 2)
     and its resume, and `python -m kaminpar_tpu_torch.dcli` at D = 8 (in
     this process) giving the facade's partition;
  12b. dKaMinPar on 8 shards of the card at full width, k=16, eps=0.03,
     seed=1: `default` on large and on medium, medium with the scatter
     engine and with local-lp + scatter (the only cell that passes
     label_range= to the standalone K3), each cut pinned to the JAX
     package's CPU run on 8 devices (EXPECTED_DIST_CUTS), K1 and K2
     launched in every cell and the standalone K3 in the two scatter
     cells, each counted from zero; prints the walls per phase, the
     levels, the first level's per-shard edges and the peak allocation.
  13a. partitioning as a service at n = 2^14, k=8: one batch (the graph
     object and its `gen:` spec) through PartitionService on the CPU and
     on the card, in this process, verdicts and partitions bitwise equal
     (and phase 4's partition); then the same two requests in a worker
     process that the service spawns on the card, with equal partitions,
     then an injected worker hang (SIGKILLed past its 5 s ceiling:
     failed/worker-hang) and an injected worker crash (failed/
     worker-crash);
  13b. the service at full width, k=16, eps=0.03, seed=1, in this
     process with a metrics file (scraped mid-batch) and a heartbeat:
     the large graph (cut 2,971,596, phase 5's partition), its duplicate
     from the result cache with no kernel launch, the medium graph
     (250,236, the fused K3 launched); the medium graph in the service's
     worker on the card (13a's service: the queue keeps serving after
     the hang and the crash), its partition phase 5's and the worker's
     own K1, K2 and fused K3 launches in its reply; and `python -m
     kaminpar_tpu_torch --serve-batch` in a subprocess on the medium
     spec and its duplicate with `--trace-out`, `--metrics-file` and
     `--heartbeat-file`.  Prints the serve wall against phase 5's direct
     wall, the spawn handshakes, the npz shipping, the worker's RSS and
     each request's peak device allocation.
  14a. the observatory with every layer on (telemetry, progress, quality,
     perf, ledger) at n = 2^14, k=8, on the CPU and on the card: phase
     4's partition on both, and equal progress series, quality rows,
     pad-waste rows, memory stages and transfer rows;
  14b. the large and the medium graph, `default`, k=16, with every layer
     on: phase 5's partitions and pinned cuts, the wall beside a
     layers-off run of the same graph in this process, the roofline row
     of every scope that launched a kernel held to the launches and the
     bytes the package's cost functions give, the quality headline and
     the level that coarsening locked the most, the csr-upload bytes (at
     least the large graph's padded CSR), the allocator's samples at
     every barrier and the build account;
  14c. the medium scatter cell on 8 shards with every layer on: its
     pinned cut, and a roofline row of the standalone K3;
  14d. `python -m kaminpar_tpu_torch.telemetry.top` and `.quality` on
     14b's large report (run in this process by runpy, as -m runs them),
     and the CLI on the n = 2^14 spec with a fresh
     KAMINPAR_TPU_NATIVE_CACHE_DIR: every nvcc build lands inside the
     scope that first launched its kernel, and its seconds are taken out
     of that scope's roofline wall.
  15. the 64-bit weight build, in a child process of this script run with
     KAMINPAR_TPU_64BIT=1 (the flag is read at import) on heavy copies of
     the bench graphs (heavy_copy: tests/test_64bit.py's edge weights,
     node weights from [2^20, 2^21), every block of k=16 past 2^31):
     15a each int64 kernel variant (K1 gather_i64, K2, the standalone and
     the fused K3) bitwise against its twin at the heavy graphs' level-0
     shapes and on edge cases (connection sums past 2^31, cluster weight
     plus node weight wrapping past int64's max beside the cap, the int64
     sentinel, hashed ties, num_slots 256), timed beside bound, twin and
     (K1, K2) one PyTorch call; 15b the heavy n = 2^14 graph, CPU against
     card bitwise; 15c `default` on heavy medium (the JAX package's
     pinned cut) and heavy large, each counted from zero: the int64
     variants launched, K2's and both K3s' int32 variants never, block
     weights recounted in int64 within the caps, the walls beside phase
     5's; 15d dKaMinPar on heavy medium, 8 shards, the scatter engine
     (the standalone K3's int64 variant); 15e both command lines in
     subprocesses, the partitions of 15c and 15d; 15f
     KAMINPAR_TPU_ASSERTS=1 leaves 15c's partition, and a graph corrupted
     after set_graph is refused at the output gate by name.
  Phases 5, 7b, 8b, 9b, 12b and 15c fail on any degradation, rung,
     spill, wind-down or integrity-violation event;
  6. print the per-kernel JSON line (each kernel's bound, per-launch
     bytes and cost function from the package's cost functions), then
     the final status line.

The rating engine is chosen per level from the graph's density: the large
graph (average degree 33 > 32 slots) takes the sort2 engine at every
level and never reaches K3, the medium graph (average degree 26) takes
the scatter engine, which is the fused K3.  So the main path is both
graphs.  The standalone K3 (the table's arg-max alone) runs on the dist
path's scatter engine (phase 12b), whose sharded layout has no row spans
for the fused kernel; its `launches` in the JSON line are phase 12b's.

Takes no arguments.  Exits non-zero without a result when CUDA is
unavailable or the package is missing.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import runpy
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor
# 32-bit rate used for the integer operation count
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
K_MAIN = 16
# the main path's cuts (k=16, eps=0.03, seed=1): the pipeline is integer
# arithmetic with hashed tie-breaks, and every run of the port since its
# native IP (PERF.md) gave these; another cut is another partition
EXPECTED_CUTS = {"large": 2_971_596, "medium": 250_236}
# the slice's presets on the medium graph, k=16, eps=0.03, seed=1: the
# cuts of the JAX package's CPU runs (PERF.md gives the command), the
# only link between a card run and the reference
EXPECTED_PRESET_CUTS = {
    ("medium", "mtkahypar-kway"): 250_650,
    ("medium", "vcycle"): 247_293,
}
# compressed and streamed inputs (phase 8b), k=16, eps=0.03, seed=1: the
# cuts of the JAX package's CPU runs (PERF.md gives the commands)
EXPECTED_STREAM_CUTS = {
    ("medium", "terapart"): 250_236,
    ("large", "terapart"): 2_971_596,
    ("large", "external"): 7_674_977,
    ("large", "external, 96 MiB"): 7_818_950,
}
# the budget of the budgeted external run, and the levels the JAX
# package streamed under it
STREAM_BUDGET = 96 << 20
STREAM_BUDGET_LEVELS = 7
# graph files, overlay coarsening and the warm start (phase 9b), k=16,
# eps=0.03, seed=1: the cuts of the JAX package's CPU runs (PERF.md gives
# the commands; a graph read back from a file is the in-memory graph, so
# it keeps that graph's pin)
EXPECTED_FILE_CUTS = {
    ("large", "default, from ParHiP"): 2_971_596,
    ("large", "external, lazy compressed"): 7_674_977,
    ("medium", "default, from METIS"): 250_236,
    ("medium", "overlay"): 250_074,
    ("medium", "vcycle warm, max_levels 2"): 247_293,
}
# resilience (phase 10b), medium graph, k=16, eps=0.03, seed=1: the cuts
# of the JAX package's CPU runs under the same forced rung, budget, fault
# plan or stop point (PERF.md section 4); True where the run must give
# phase 5's medium partition bitwise
EXPECTED_RESILIENCE_CUTS = {
    "rung 1": (250_236, True),
    "24 MiB budget": (250_236, True),
    "device-oom:nth=1": (250_236, True),
    "resume uncoarsen:1!": (250_236, True),
    "16 MiB budget": (475_285, False),
    "rung 4": (255_835, False),
    "soft stop coarsen:1": (417_872, False),
    "soft stop initial": (425_329, False),
    "soft stop uncoarsen:1": (366_511, False),
    "soft stop coarsen:3": (250_236, True),
}
# forced rung 1 (tight pads) on the large graph, k=16, eps=0.03, seed=1:
# the cut and the sha256 of the int32 partition of the JAX package's CPU
# run under KAMINPAR_TPU_MEM_RUNG=1 (PERF.md section 4); phase 10d holds
# the port's forced rung 1 to both, and its capped run to that partition
EXPECTED_LARGE_RUNG1 = (
    2_980_700,
    "6b4603766dec9ffb1161bd36affbb5abd5e3f56963cc24be7ba143712b855ab8",
)
# the dist path (phase 12b), k=16, eps=0.03, seed=1, 8 shards: the cuts of
# the JAX package's CPU runs on 8 virtual devices (PERF.md section 4 gives
# the command); (graph, variant) -> cut
EXPECTED_DIST_CUTS = {
    ("large", "default"): 8_066_073,
    ("medium", "default"): 480_323,
    ("medium", "scatter"): 483_412,
    ("medium", "local-lp"): 468_121,
}
DIST_SHARDS = 8
# the card's name and power limit as nvidia-smi prints them, stamped on
# every load time and wall of phases 9 and 10
CARD = None
# the resilience layer's telemetry events of the run in progress, seen
# whether or not telemetry records (install_event_spy): a run that neither
# injects, budgets nor stops must leave none
RESILIENCE_EVENTS = []
# seconds since the script started, printed with each partition run
T_START = time.perf_counter()
# how device_ms took its times: profiler sessions that recorded device
# time, sessions that recorded none, and calls timed by CUDA events
DEVICE_TIMING = {"profiler": 0, "empty_profiles": 0, "cuda_events": 0}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, torch, reps: int = 10, warmup: int = 3,
            batch: int = 10) -> float:
    """Time of one call: CUDA events around `batch` calls in a row (so the
    host's launch work overlaps the device's), over `batch`; the median
    of `reps` such runs, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(statistics.median(times))


def device_ms(fn, torch, reps: int = 20) -> tuple[float, dict, str]:
    """Device time of one call: the summed time of every kernel and memset
    the call ran on the card, from torch.profiler over `reps` calls after
    warm-up, that time per kernel name, and "profiler".  Unlike time_ms it
    leaves out the gaps the host leaves between launches, which a wrapper
    whose host work outlasts its kernels would otherwise be charged.

    CUPTI at times hands back no kernel records for a session.  The
    profiler is then asked twice more; if it still sees nothing, the call
    is timed alone between two CUDA events (events_ms), which counts the
    host's gaps inside the call, and the third item says "cuda_events"."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {ev.key: ev.device_time_total / reps / 1e3  # microseconds
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA}
        if per:
            DEVICE_TIMING["profiler"] += 1
            return sum(per.values()), per, "profiler"
        DEVICE_TIMING["empty_profiles"] += 1
        print(f"chip_smoke: torch.profiler recorded no device time "
              f"(attempt {attempt + 1} of 3)", file=sys.stderr, flush=True)
    DEVICE_TIMING["cuda_events"] += 1
    ms = events_ms(fn, torch, reps)
    return ms, {"cuda_events": ms}, "cuda_events"


def events_ms(fn, torch, reps: int) -> float:
    """Median time of one call on its own, between two CUDA events, the
    card idle before it."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(statistics.median(times))


def timed_s(fn) -> float:
    """Seconds `fn()` takes on the host clock."""
    t0 = time.perf_counter()
    fn()
    return round(time.perf_counter() - t0, 3)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cost_bound(cost) -> tuple[float, str, int]:
    """(bound ms, what bounds it, bytes) of one launch from its kernel's
    cost function in the package (ops/gather.py, ops/rating.py): each
    input byte read once, each output byte written once."""
    nbytes, ops = (int(v) for v in cost)
    return (*bound_ms(nbytes, ops), nbytes)


# each kernel's cost function, as the execution ledger calls it
COST_FUNCTIONS = {
    "gather_i32": "kaminpar_tpu_torch.ops.gather.gather_i32_cost",
    "dense_block_ratings":
        "kaminpar_tpu_torch.ops.gather.dense_block_ratings_cost",
    "best_from_slots": "kaminpar_tpu_torch.ops.rating.best_from_slots_cost",
    "scatter_best_from_slots":
        "kaminpar_tpu_torch.ops.rating.scatter_best_from_slots_cost",
    "gather_i64": "kaminpar_tpu_torch.ops.gather.gather_i64_cost",
    "dense_block_ratings_i64":
        "kaminpar_tpu_torch.ops.gather.dense_block_ratings_i64_cost",
    "best_from_slots_i64":
        "kaminpar_tpu_torch.ops.rating.best_from_slots_i64_cost",
    "scatter_best_from_slots_i64":
        "kaminpar_tpu_torch.ops.rating.scatter_best_from_slots_i64_cost",
}


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    try:
        import kaminpar_tpu_torch as kp
        from kaminpar_tpu_torch import _native, native
        from kaminpar_tpu_torch.graphs.csr import device_graph_from_host
        from kaminpar_tpu_torch.graphs.factories import make_rmat
        from kaminpar_tpu_torch.graphs.host import remove_isolated_nodes
        from kaminpar_tpu_torch.ops import gather, metrics, rating, segments
        from kaminpar_tpu_torch.partitioning.coarsener import Coarsener
    except ImportError as exc:
        fail(f"kaminpar_tpu_torch is not importable here ({exc})")

    # -- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    global CARD
    CARD = smi
    dev = torch.device("cuda")
    # the facade prints its banner and RESULT line at the default level
    from kaminpar_tpu_torch.utils.logger import OutputLevel, set_output_level

    set_output_level(OutputLevel.QUIET)
    install_event_spy()

    # -- 2. build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        host_libs = {src: pool.submit(timed_s, build)
                     for src, build in (("ip.cpp", native.build),
                                        ("fm.cpp", native.build_fm),
                                        ("codec.cpp+codec2.cpp",
                                         native.build_codec))}
        build_s = _native.build()
        host_s = {src: f.result() for src, f in host_libs.items()}
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3),
                      "per_source_s": {k: round(v, 3)
                                       for k, v in build_s.items()},
                      "host_lib_s": host_s}),
          flush=True)
    print(json.dumps({"registers": kernel_registers(_native)}), flush=True)

    # -- 3. kernels vs twins at the main path's shapes
    main_runs = [
        # (name, n, m, seed): bench.py's large (:337) and medium (:278-280)
        ("large", 1 << 20, 10_000_000, 7),
        ("medium", 1 << 16, 600_000, 3),
    ]
    graphs = {}
    for name, n, m, seed in main_runs:
        t0 = time.perf_counter()
        g = make_rmat(n, m, seed=seed)
        core, perm, _ = remove_isolated_nodes(g)
        graphs[name] = (g, core, perm)
        print(json.dumps({"graph": name,
                          "spec": f"make_rmat({n}, {m}, seed={seed})",
                          "n": g.n, "m": g.m, "core_n": core.n,
                          "generate_s": round(time.perf_counter() - t0, 3)}),
              flush=True)

    rng = np.random.default_rng(11)
    kernels = []
    # K1 and K2 at the large graph's level 0 (the first LP round's
    # labels[dst] and the first refinement's (n_pad, 16) table)
    dg = device_graph_from_host(graphs["large"][1], dev)
    n_pad, m_pad = dg.n_pad, dg.m_pad
    labels = torch.from_numpy(
        rng.integers(0, n_pad, n_pad, dtype=np.int32)).to(dev)
    part = torch.from_numpy(
        rng.integers(0, K_MAIN, n_pad, dtype=np.int32)).to(dev)

    out = gather.gather_i32(labels, dg.dst)
    ref = gather.gather_i32_twin(labels, dg.dst)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fail("K1 gather_i32 disagrees with its twin")
    # an odd-length view at every offset from a 16-byte boundary
    for off in range(4):
        view = dg.dst[off: off + 1_000_001]
        if not torch.equal(gather.gather_i32(labels, view),
                           gather.gather_i32_twin(labels, view)):
            fail(f"K1 gather_i32 disagrees on a view at offset {off}")
    b, by, per_launch = cost_bound(gather.gather_i32_cost(labels, dg.dst))
    ms, _, ms_by = device_ms(lambda: gather.gather_i32(labels, dg.dst), torch)
    kernels.append({
        "name": "gather_i32", "route": "cuda",
        "source": "kaminpar_tpu_torch/csrc/gather.cu",
        "replaces": "kaminpar_tpu/ops/lane_gather.py:268",
        "max_abs_err": max_abs_err(out, ref),
        "ms": ms, "ms_by": ms_by,
        "call_ms": time_ms(lambda: gather.gather_i32(labels, dg.dst), torch),
        "plain_ms": time_ms(
            lambda: gather.gather_i32_twin(labels, dg.dst), torch),
        "bound_ms": b, "bound_by": by,
        "bytes_per_launch": per_launch,
        "cost_function": COST_FUNCTIONS["gather_i32"],
        "library_ms": time_ms(lambda: labels[dg.dst], torch),
        "shape": {"graph": "large", "table": n_pad, "idx": m_pad},
    })

    spans = (dg.row_ptr[:-1], dg.row_ptr[1:])
    args2 = (*spans, dg.dst, dg.edge_w, part, n_pad, K_MAIN)
    out = gather.dense_block_ratings(*args2)
    ref = gather.dense_block_ratings_twin(*args2)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fail("K2 dense_block_ratings disagrees with its twin")
    check_k2_edge_cases(dg, gather, segments, rng, dev, torch)

    def library_k2():
        flat = (dg.src.to(torch.int64) * K_MAIN
                + part.clamp(0, K_MAIN - 1)[dg.dst])
        conn = torch.zeros(n_pad * K_MAIN, dtype=torch.int32, device=dev)
        conn.index_put_((flat,), dg.edge_w, accumulate=True)
        return conn

    # the spans, the real edges' dst and w, the labels, and the table
    # written once; one add per real edge
    b, by, per_launch = cost_bound(gather.dense_block_ratings_cost(*args2))
    ms, _, ms_by = device_ms(lambda: gather.dense_block_ratings(*args2),
                             torch)
    kernels.append({
        "name": "dense_block_ratings", "route": "cuda",
        "source": "kaminpar_tpu_torch/csrc/dense_ratings.cu",
        "replaces": "kaminpar_tpu/ops/lane_gather.py:268",
        "max_abs_err": max_abs_err(out, ref),
        "ms": ms, "ms_by": ms_by,
        "call_ms": time_ms(lambda: gather.dense_block_ratings(*args2),
                           torch),
        "plain_ms": time_ms(
            lambda: gather.dense_block_ratings_twin(*args2), torch),
        "bound_ms": b, "bound_by": by,
        "bytes_per_launch": per_launch,
        "cost_function": COST_FUNCTIONS["dense_block_ratings"],
        "library_ms": time_ms(library_k2, torch, reps=3, warmup=1,
                              batch=1),
        "shape": {"graph": "large", "edges": dg.m, "slots": m_pad,
                  "rows": n_pad, "k": K_MAIN},
    })
    del out, ref, labels, part, dg

    # K3, standalone and fused, on the medium graph's level 0 (the scatter
    # engine's first round: every node its own cluster)
    kernels += check_k3(graphs["medium"][1], kp, gather, rating, segments,
                        Coarsener, device_graph_from_host, rng, dev, torch)
    # the standalone K3 with its masks and K2 with a ghost table, at the
    # dist path's shard shapes
    dist_fields = check_dist_kernels(graphs["medium"][0], kp, gather, rating,
                                     dev, torch)
    for entry in kernels:
        entry.update(dist_fields.get(entry["name"], {}))
    torch.cuda.empty_cache()
    print(json.dumps({"kernel_checks": "ok"}), flush=True)

    # -- 4. the whole path at n = 2^14: CPU and card bitwise equal
    g_small = make_rmat(1 << 14, 120_000, seed=3)
    parts = {}
    for device in ("cpu", "cuda"):
        calls = native.ml_bipartition.calls
        t0 = time.perf_counter()
        parts[device] = kp.KaMinPar("default", device=device).set_graph(
            g_small).compute_partition(k=8, epsilon=0.03, seed=1)
        calls = native.ml_bipartition.calls - calls
        print(json.dumps({"small_run": device, "native_ip_calls": calls,
                          "wall_s": round(time.perf_counter() - t0, 3)}),
              flush=True)
        if calls <= 0:
            fail(f"n=2^14 on {device}: the native initial bipartitioner "
                 "did not run")
    if not np.array_equal(parts["cpu"], parts["cuda"]):
        fail("n=2^14: CPU and CUDA partitions differ in "
             f"{int((parts['cpu'] != parts['cuda']).sum())} nodes")
    print(json.dumps({"small_parity": "bitwise-equal"}), flush=True)
    small_default = parts["cpu"]

    # -- 5. the main path; the standalone K3 is off it (the scatter engine
    # runs the fused K3) and is counted only to show so
    path_kernels = (gather.gather_i32, gather.dense_block_ratings,
                    rating.scatter_best_from_slots)
    counted = path_kernels + (rating.best_from_slots,)
    for fn in counted:
        fn.launches = 0
    path_ms = {fn.__name__: {} for fn in counted}
    main_parts, main_walls = {}, {}
    for name, n, m, seed in main_runs:
        _native.EVENT_LOG = {}
        native.ml_bipartition.calls = 0
        main_parts[name], main_solver = run_main(
            name, graphs[name][0], kp, counted, dev, metrics,
            device_graph_from_host, torch, "default", EXPECTED_CUTS[name])
        main_walls[name] = main_solver.smoke_wall
        torch.cuda.synchronize()
        for fname, events in _native.EVENT_LOG.items():
            path_ms[fname][name] = sum(a.elapsed_time(b) for a, b in events)
        _native.EVENT_LOG = None
        if native.ml_bipartition.calls <= 0:
            fail(f"main path ({name}): the native initial bipartitioner "
                 "did not run")
        print(json.dumps({"native_ip": name, "calls":
                          native.ml_bipartition.calls}), flush=True)
    launches = {fn.__name__: fn.launches for fn in counted}
    for fn in path_kernels:
        if launches[fn.__name__] <= 0:
            fail(f"main path: kernel {fn.__name__} was never launched")

    # -- 7a. the slice's paths at n = 2^14: CPU and card bitwise equal
    for preset, workers in (("strong", 1), ("mtkahypar-kway", 1),
                            ("vcycle", 1), ("default", 4)):
        run = preset if workers == 1 else f"deep, {workers} workers"
        parts = {}
        for device in ("cpu", "cuda"):
            fm_calls = native.fm_refine.calls
            solver = kp.KaMinPar(preset, device=device)
            solver.ctx.parallel.num_workers = workers
            t0 = time.perf_counter()
            parts[device] = solver.set_graph(g_small).compute_partition(
                k=8, epsilon=0.03, seed=1)
            fm_calls = native.fm_refine.calls - fm_calls
            print(json.dumps({"small_run": run, "device": device,
                              "native_fm_calls": fm_calls,
                              "wall_s": round(time.perf_counter() - t0, 3)}),
                  flush=True)
            if preset == "strong" and fm_calls <= 0:
                fail(f"n=2^14 strong on {device}: the native FM did not run")
        if not np.array_equal(parts["cpu"], parts["cuda"]):
            fail(f"n=2^14 {run}: CPU and CUDA partitions differ in "
                 f"{int((parts['cpu'] != parts['cuda']).sum())} nodes")
        print(json.dumps({"small_parity": run, "result": "bitwise-equal"}),
              flush=True)

    # -- 7b. the slice's paths at full width, each counted from zero
    slice_runs = {}
    for cell, preset in EXPECTED_PRESET_CUTS:
        for fn in counted:
            fn.launches = 0
        _native.EVENT_LOG = {}
        run_main(cell, graphs[cell][0], kp, counted, dev, metrics,
                 device_graph_from_host, torch, preset,
                 EXPECTED_PRESET_CUTS[(cell, preset)])
        torch.cuda.synchronize()
        run_ms = {fname: sum(a.elapsed_time(b) for a, b in events)
                  for fname, events in _native.EVENT_LOG.items()}
        _native.EVENT_LOG = None
        run_launches = {fn.__name__: fn.launches for fn in counted}
        for fn in path_kernels:
            if run_launches[fn.__name__] <= 0:
                fail(f"{cell}/{preset}: kernel {fn.__name__} was never "
                     "launched")
        slice_runs[f"{cell}/{preset}"] = (run_launches, run_ms)
        print(json.dumps({"slice_path": f"{cell}/{preset}",
                          "launches": run_launches, "path_ms": run_ms}),
              flush=True)

    # -- 8. compressed and streamed inputs
    check_stream_parity(g_small, kp, native, torch)
    slice_runs.update(run_stream_paths(graphs, kp, counted, path_kernels,
                                       dev, metrics, device_graph_from_host,
                                       torch))

    # -- 7c. the fused K3 with communities from phase 5's medium partition
    g_med, core_med, perm_med = graphs["medium"]
    communities = check_k3_communities(
        core_med, main_parts["medium"][perm_med.new_to_old[: core_med.n]],
        kp, rating, Coarsener, device_graph_from_host, dev, torch)

    # -- 9. graph files, overlay and noop coarsening, the warm start and
    # the telemetry core
    check_file_parity(g_small, small_default, kp, torch)
    slice_runs.update(run_file_paths(graphs, main_parts, kp, counted,
                                     path_kernels, dev, metrics,
                                     device_graph_from_host, torch))

    # -- 10. resilience: the memory governor's rungs, checkpoints and
    # resume, the anytime wind-down, fault injection, a genuine CUDA
    # out-of-memory error and the integrity sentinels
    check_resilience_parity(g_small, small_default, kp, torch)
    slice_runs.update(run_resilience_paths(graphs, main_parts, kp, counted,
                                           path_kernels, dev, metrics,
                                           device_graph_from_host, torch))

    # -- 11. dynamic sessions, the CLI, the tools and the C ABI
    print(json.dumps({"phase_11_at_s": round(time.perf_counter() - T_START,
                                             1)}), flush=True)
    if os.environ.get("KAMINPAR_TPU_PLATFORM", "").strip() == "cpu":
        fail("KAMINPAR_TPU_PLATFORM=cpu would put the C ABI on the CPU")
    tmp = tempfile.mkdtemp(prefix="kp-smoke-dynamic-")
    try:
        c_abi = check_dynamic_parity(g_small, small_default, kp, tmp)
        slice_runs.update(run_dynamic_paths(graphs, main_parts, kp, counted,
                                            path_kernels, tmp, c_abi, torch))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 12. the distributed partitioner
    print(json.dumps({"phase_12_at_s": round(time.perf_counter() - T_START,
                                             1)}), flush=True)
    tmp = tempfile.mkdtemp(prefix="kp-smoke-dist-")
    try:
        check_dist_parity(g_small, kp, torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dist_runs = run_dist_paths(graphs, kp, counted, dev, torch)
    slice_runs.update(dist_runs)
    dist_launches = {fn.__name__: sum(r[fn.__name__]
                                      for r, _ in dist_runs.values())
                     for fn in counted}

    # -- 13. partitioning as a service: PartitionService in this process
    # and in a spawned worker on the card, the CLI's --serve-batch
    print(json.dumps({"phase_13_at_s": round(time.perf_counter() - T_START,
                                             1)}), flush=True)
    tmp = tempfile.mkdtemp(prefix="kp-smoke-serving-")
    try:
        worker_svc = check_serving_parity(g_small, small_default, kp, torch)
        try:
            slice_runs.update(run_serving_paths(
                graphs, main_parts, main_walls, worker_svc, kp, counted,
                path_kernels, torch, tmp))
        finally:
            worker_svc.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"phase_13_done_at_s": round(
        time.perf_counter() - T_START, 1)}), flush=True)

    # -- 14. the observatory: progress series, cut-loss attribution, the
    # roofline over the hand-written kernels, memory watermarks, padding
    # waste, the execution ledger, the build account and the renderers
    print(json.dumps({"phase_14_at_s": round(time.perf_counter() - T_START,
                                             1)}), flush=True)
    tmp = tempfile.mkdtemp(prefix="kp-smoke-observatory-")
    try:
        slice_runs.update(run_observatory(
            graphs, main_parts, main_walls, g_small, small_default, kp,
            counted, path_kernels, dev, metrics, device_graph_from_host,
            torch, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 15. the 64-bit weight build (KAMINPAR_TPU_64BIT=1): the int64
    # kernels against their twins, its main path on the heavy graphs, the
    # dist cell, both command lines and the assertion switch, in a child
    # process (the flag is read when the package is first imported)
    print(json.dumps({"phase_15_at_s": round(time.perf_counter() - T_START,
                                             1)}), flush=True)
    kernels_64 = run_phase_15(graphs, main_walls)

    for entry in kernels:
        name = entry["name"]
        # the shared-memory main path (phase 5) for the kernels it runs;
        # the standalone K3 runs only on the dist path (phase 12b)
        if launches[name] > 0:
            entry["launches"] = launches[name]
            entry["launches_from"] = "phase 5"
        else:
            entry["launches"] = dist_launches[name]
            entry["launches_from"] = "phase 12b"
        entry["path_ms"] = path_ms[name]
        for run, (run_launches, run_ms) in slice_runs.items():
            entry.setdefault("path_launches", {})[run] = run_launches[name]
            entry["path_ms"][run] = run_ms.get(name, 0.0)
        entry["on_path"] = entry["launches"] > 0
        entry["ok"] = True
        if entry["name"] == "scatter_best_from_slots":
            entry["communities"] = communities
    kernels += kernels_64
    print(json.dumps({"device_timing": DEVICE_TIMING}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def external_ctx(chunk_edges=None, budget=None, contraction_limit=None,
                 min_stream_levels=None):
    """A configure(ctx) for the external scheme.  A budget is the
    external scheme's own (chunk size and stream depth): its pins were
    taken with the JAX memory governor off, and `configure.env` switches
    the port's off the same way."""
    def configure(ctx):
        from kaminpar_tpu_torch.context import PartitioningMode

        ctx.partitioning.mode = PartitioningMode.EXTERNAL
        if chunk_edges is not None:
            ctx.external.chunk_edges = chunk_edges
        if budget is not None:
            ctx.resilience.memory_budget = float(budget)
        if contraction_limit is not None:
            ctx.coarsening.contraction_limit = contraction_limit
        if min_stream_levels is not None:
            ctx.external.min_stream_levels = min_stream_levels
    configure.env = ({"KAMINPAR_TPU_MEM_GOVERNOR": "0"}
                     if budget is not None else {})
    return configure


@contextlib.contextmanager
def env_scope(env):
    """Set the variables of `env` for the block, restoring them after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


STREAM_RUNS = {
    # run: (preset, configure)
    "terapart": ("terapart", None),
    "terapart-largek": ("terapart-largek", None),
    "external": ("default", external_ctx()),
    "external, 96 MiB": ("default", external_ctx(budget=STREAM_BUDGET)),
}


def check_stream_parity(g_small, kp, native, torch) -> None:
    """Phase 8a: compressed and streamed inputs at n = 2^14 on the CPU
    and on the card, each pair of partitions bitwise equal."""
    runs = {
        "terapart": ("terapart", None, None),
        "terapart-largek": ("terapart-largek", None, None),
        "external, 2^15-edge chunks": (
            "default", external_ctx(chunk_edges=1 << 15), 1),
        # contraction limit 160: the default 2000 stops streaming once a
        # level has at most 4000 nodes, which this graph reaches after one
        "external, 3,000,000-byte budget": (
            "default", external_ctx(budget=3_000_000,
                                    contraction_limit=160), 2),
    }
    for run, (preset, configure, levels) in runs.items():
        parts = {}
        for device in ("cpu", "cuda"):
            solver = kp.KaMinPar(preset, device=device)
            if configure is not None:
                configure(solver.ctx)
            t0 = time.perf_counter()
            with env_scope(getattr(configure, "env", {})):
                parts[device] = solver.set_graph(g_small).compute_partition(
                    k=8, epsilon=0.03, seed=1)
            record = solver.last_external or {}
            chunks = [lv["chunks"] for lv in record.get("levels", [])]
            print(json.dumps({"small_run": run, "device": device,
                              "streamed_chunks": chunks,
                              "wall_s": round(time.perf_counter() - t0, 3)}),
                  flush=True)
            if levels is not None and len(chunks) != levels:
                fail(f"n=2^14 {run} on {device}: {len(chunks)} streamed "
                     f"levels, expected {levels}")
            if levels is not None and chunks[0] < 2:
                fail(f"n=2^14 {run} on {device}: level 0 streamed in "
                     f"{chunks[0]} chunk(s)")
        if not np.array_equal(parts["cpu"], parts["cuda"]):
            fail(f"n=2^14 {run}: CPU and CUDA partitions differ in "
                 f"{int((parts['cpu'] != parts['cuda']).sum())} nodes")
        print(json.dumps({"small_parity": run, "result": "bitwise-equal"}),
              flush=True)


def run_stream_paths(graphs, kp, counted, path_kernels, dev, metrics,
                     device_graph_from_host, torch, runs=None) -> dict:
    """Phase 8b: the compressed and streamed paths at full width (or the
    given `runs`: (cell, run, preset, configure, pinned cut, graph to
    partition)).  For an external run the launches and CUDA-event times
    are split at the in-core handoff ("<cell>/<run>: stream" and
    ": handoff"), and the stream's peak device allocation is read there.
    Returns the runs' (launches, path_ms) for the kernels line."""
    from kaminpar_tpu_torch import _native
    from kaminpar_tpu_torch.external import driver

    at_handoff = {}
    incore = driver.ExternalPartitioner._incore_partition

    def hooked(self, handoff):
        torch.cuda.synchronize()
        at_handoff["launches"] = {fn.__name__: fn.launches for fn in counted}
        at_handoff["events"] = {name: len(ev) for name, ev in
                                (_native.EVENT_LOG or {}).items()}
        at_handoff["peak"] = torch.cuda.max_memory_allocated()
        return incore(self, handoff)

    driver.ExternalPartitioner._incore_partition = hooked
    if runs is None:
        runs = [(cell, run, *STREAM_RUNS[run], pinned, graphs[cell][0])
                for (cell, run), pinned in EXPECTED_STREAM_CUTS.items()]
    results = {}
    try:
        for cell, run, preset, configure, pinned, graph in runs:
            for fn in counted:
                fn.launches = 0
            at_handoff.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _native.EVENT_LOG = {}
            _, solver = run_main(cell, graph, kp, counted, dev,
                                 metrics, device_graph_from_host, torch,
                                 preset, pinned, configure, run,
                                 check_graph=graphs[cell][0])
            torch.cuda.synchronize()
            log, _native.EVENT_LOG = _native.EVENT_LOG, None
            launches = {fn.__name__: fn.launches for fn in counted}
            run_ms = {name: sum(a.elapsed_time(b) for a, b in ev)
                      for name, ev in log.items()}
            key = f"{cell}/{run}"
            if solver.last_external is None:
                needed = path_kernels[:2] if cell == "large" else path_kernels
                for fn in needed:
                    if launches[fn.__name__] <= 0:
                        fail(f"{key}: kernel {fn.__name__} was never "
                             "launched")
                results[key] = (launches, run_ms)
                print(json.dumps({
                    "stream_path": key,
                    "compression_ratio": solver.graph().compression_ratio(),
                    "compressed_bytes": solver.graph().memory_bytes(),
                    "launches": launches, "path_ms": run_ms}), flush=True)
                continue
            stream = at_handoff["launches"]
            handoff = {k: launches[k] - stream[k] for k in launches}
            stream_ms = {name: sum(a.elapsed_time(b) for a, b in
                                   log[name][: at_handoff["events"].get(
                                       name, 0)])
                         for name in log}
            handoff_ms = {k: run_ms[k] - stream_ms.get(k, 0.0)
                          for k in run_ms}
            if stream["gather_i32"] <= 0:
                fail(f"{key}: K1 was never launched inside the stream")
            for fn in path_kernels[:2]:
                if handoff[fn.__name__] <= 0:
                    fail(f"{key}: kernel {fn.__name__} was never launched "
                         "in the in-core handoff")
            record = solver.last_external
            peak = at_handoff["peak"] - base
            if peak >= record["fine_csr_bytes"]:
                fail(f"{key}: the stream's peak device allocation {peak} "
                     f"reached the fine graph's CSR bytes "
                     f"{record['fine_csr_bytes']}")
            levels = record["streamed_levels"]
            if run.endswith("MiB") and levels != STREAM_BUDGET_LEVELS:
                fail(f"{key}: streamed {levels} levels, the JAX package "
                     f"streamed {STREAM_BUDGET_LEVELS}")
            results[f"{key}: stream"] = (stream, stream_ms)
            results[f"{key}: handoff"] = (handoff, handoff_ms)
            print(json.dumps({
                "stream_path": key, "external": record,
                "stream_peak_allocated_bytes": peak,
                "phase_s": solver.last_timings,
                "stream_launches": stream, "handoff_launches": handoff,
                "stream_ms": stream_ms, "handoff_ms": handoff_ms}),
                flush=True)
    finally:
        driver.ExternalPartitioner._incore_partition = incore
    return results


def write_graph_files(graph, cgraph, directory, formats) -> dict:
    """Write `graph` in each format (the compressed container from
    `cgraph`, ZIP_STORED so that it loads lazily); returns {format:
    (path, seconds, bytes)}."""
    from kaminpar_tpu_torch import io as kio

    files = {}
    for fmt in formats:
        t0 = time.perf_counter()
        if fmt == "metis":
            path = os.path.join(directory, "g.metis")
            kio.write_metis(graph, path)
        elif fmt == "parhip":
            path = os.path.join(directory, "g.parhip")
            kio.write_parhip(graph, path)
        else:
            path = os.path.join(directory, "g.npz")
            kio.write_compressed(path, cgraph, compress=False)
        files[fmt] = (path, time.perf_counter() - t0, os.path.getsize(path))
    return files


COMPRESSED_MEMBERS = ("xadj", "offsets", "data", "node_weights",
                      "edge_weights", "wdata", "woffsets")


def check_loaded(what, loaded, graph, cgraph, lazy=False) -> None:
    """A graph read back from a file holds the written arrays exactly: a
    HostGraph the in-memory graph's, a compressed container the in-memory
    compressed graph's (memory-mapped when loaded lazily)."""
    if hasattr(loaded, "offsets"):
        ref, names = cgraph, COMPRESSED_MEMBERS
        if loaded.codec != cgraph.codec:
            fail(f"{what}: codec {loaded.codec}, written {cgraph.codec}")
    else:
        ref, names = graph, ("xadj", "adjncy", "node_weights",
                             "edge_weights")
    for name in names:
        a, b = getattr(loaded, name), getattr(ref, name)
        if (a is None) != (b is None) or (
                a is not None and not np.array_equal(np.asarray(a),
                                                     np.asarray(b))):
            fail(f"{what}: {name} differs from the written graph")
    if lazy and not isinstance(loaded.data, np.memmap):
        fail(f"{what}: the lazy load did not map the container")


def load_timed(what, path, kp, graph, cgraph, lazy=False):
    t0 = time.perf_counter()
    loaded = kp.load_graph(path, lazy=lazy)
    load_s = time.perf_counter() - t0
    check_loaded(what, loaded, graph, cgraph, lazy)
    print(json.dumps({"graph_file": what, "load_s": load_s,
                      "bytes": os.path.getsize(path), "card": CARD}),
          flush=True)
    return loaded


def coarsening(algorithm):
    """A configure(ctx) for a coarsening algorithm."""
    def configure(ctx):
        from kaminpar_tpu_torch.context import CoarseningAlgorithm

        ctx.coarsening.algorithm = CoarseningAlgorithm(algorithm)
    return configure


def warm_start(partition, max_levels):
    """A prepare(solver) for the v-cycle's warm start."""
    def prepare(solver):
        solver.set_initial_partition(partition, max_levels=max_levels)
    return prepare


def check_file_parity(g_small, small_default, kp, torch) -> None:
    """Phase 9a: the slice at n = 2^14, k=8.  The graph goes through
    METIS, ParHiP and the compressed container (also loaded lazily), each
    read back to the written arrays; overlay and noop coarsening, the warm
    v-cycle from the `default` partition (max_levels 0 and 2) and
    `default` on each file's graph run on the CPU and on the card, each
    pair bitwise equal, and `default` from a file gives phase 4's
    partition."""
    from kaminpar_tpu_torch.graphs.compressed import compress_host_graph

    tmp = tempfile.mkdtemp(prefix="kp-smoke-")
    try:
        cg = compress_host_graph(g_small)
        files = write_graph_files(g_small, cg, tmp,
                                  ("metis", "parhip", "compressed"))
        loaded = {fmt: load_timed(f"small {fmt}", path, kp, g_small, cg)
                  for fmt, (path, _, _) in files.items()}
        loaded["lazy compressed"] = load_timed(
            "small lazy compressed", files["compressed"][0], kp, g_small, cg,
            lazy=True)
        runs = {
            "overlay": ("default", coarsening("overlay"), g_small, None),
            "noop": ("default", coarsening("noop"), g_small, None),
            "vcycle warm, max_levels 0": (
                "vcycle", None, g_small, warm_start(small_default, 0)),
            "vcycle warm, max_levels 2": (
                "vcycle", None, g_small, warm_start(small_default, 2)),
        }
        for fmt, graph in loaded.items():
            runs[f"default, from {fmt}"] = ("default", None, graph, None)
        for run, (preset, configure, graph, prepare) in runs.items():
            parts = {}
            for device in ("cpu", "cuda"):
                solver = kp.KaMinPar(preset, device=device)
                if configure is not None:
                    configure(solver.ctx)
                solver.set_graph(graph)
                if prepare is not None:
                    prepare(solver)
                t0 = time.perf_counter()
                parts[device] = solver.compute_partition(
                    k=8, epsilon=0.03, seed=1)
                print(json.dumps({
                    "small_run": run, "device": device,
                    "cut": solver.last_gate["cut_recomputed"],
                    "wall_s": round(time.perf_counter() - t0, 3),
                    "card": CARD}), flush=True)
            if not np.array_equal(parts["cpu"], parts["cuda"]):
                fail(f"n=2^14 {run}: CPU and CUDA partitions differ in "
                     f"{int((parts['cpu'] != parts['cuda']).sum())} nodes")
            if run.startswith("default") and not np.array_equal(
                    parts["cuda"], small_default):
                fail(f"n=2^14 {run}: not the in-memory graph's partition")
            print(json.dumps({"small_parity": run,
                              "result": "bitwise-equal"}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_report(solver, report) -> dict:
    """The telemetry run's report: valid against the port's schema, its
    scope walls the solver's `last_timings`, and clean when diffed
    against itself.  Returns a summary for the log."""
    from kaminpar_tpu_torch.telemetry.diff import diff_reports
    from kaminpar_tpu_torch.telemetry.report import validate_report

    errors = validate_report(report)
    if errors:
        fail(f"run report: {errors[:5]}")
    walls = report["scope_tree"]["partitioning"]["children"]
    for phase, seconds in solver.last_timings.items():
        node = walls.get(phase.split("/")[0], {})
        if "/" in phase:
            node = node.get("children", {}).get(phase.split("/")[1], {})
        if node.get("elapsed_s") != round(seconds, 6):
            fail(f"run report: scope {phase} {node.get('elapsed_s')} s, "
                 f"last_timings {seconds} s")
    if report["result"]["cut"] != solver.last_gate["cut_recomputed"]:
        fail("run report: its cut is not the gate's")
    _, failures = diff_reports(report, report)
    if failures:
        fail(f"run report: diffed against itself it fails: {failures}")
    return {"events": len(report["events"]),
            "levels": len(report["levels"]),
            "engines": report["rating"]["engines"],
            "kernels": report["perf"]["kernels"],
            "peak_live_bytes": report["perf"]["memory"].get(
                "peak_live_bytes"),
            "scopes": sorted(walls)}


def run_file_paths(graphs, main_parts, kp, counted, path_kernels, dev,
                   metrics, device_graph_from_host, torch) -> dict:
    """Phase 9b: the slice at full width, k=16.  The large graph is
    written as ParHiP and as a compressed container and read back (the
    container also lazily), the medium graph as METIS, read by the native
    tokenizer; `default` runs on each file's graph, overlay coarsening and
    the warm v-cycle (max_levels 2, from phase 5's partition) on the
    medium graph, `external` on the lazily loaded large container, each
    counted from zero and held to EXPECTED_FILE_CUTS; the METIS run
    records telemetry and its run report is checked.  Returns the runs'
    (launches, path_ms) for the kernels line."""
    from kaminpar_tpu_torch import _native, native, telemetry
    from kaminpar_tpu_torch.graphs.compressed import compress_host_graph
    from kaminpar_tpu_torch.telemetry.report import write_run_report

    g_large, g_med = graphs["large"][0], graphs["medium"][0]
    tmp = tempfile.mkdtemp(prefix="kp-smoke-")
    results = {}
    try:
        t0 = time.perf_counter()
        cg_large = compress_host_graph(g_large)
        compress_s = time.perf_counter() - t0
        files = write_graph_files(g_large, cg_large, tmp,
                                  ("parhip", "compressed"))
        med_dir = os.path.join(tmp, "medium")
        os.makedirs(med_dir)
        files_med = write_graph_files(g_med, None, med_dir, ("metis",))
        print(json.dumps({
            "graph_files_written": {
                f"{cell} {fmt}": {"write_s": w, "bytes": b}
                for cell, fs in (("large", files), ("medium", files_med))
                for fmt, (_, w, b) in fs.items()},
            "large_compress_s": compress_s, "card": CARD}), flush=True)
        parhip = load_timed("large parhip", files["parhip"][0], kp,
                            g_large, cg_large)
        load_timed("large compressed", files["compressed"][0], kp,
                   g_large, cg_large)
        lazy = load_timed("large lazy compressed", files["compressed"][0],
                          kp, g_large, cg_large, lazy=True)
        calls = native.parse_metis_body.calls
        metis = load_timed("medium metis", files_med["metis"][0], kp,
                           g_med, None)
        if native.parse_metis_body.calls != calls + 1:
            fail("medium metis: the native tokenizer did not read the file")

        runs = [
            ("large", "default, from ParHiP", "default", None, parhip, None),
            ("medium", "default, from METIS", "default", None, metis, None),
            ("medium", "overlay", "default", coarsening("overlay"), g_med,
             None),
            ("medium", "vcycle warm, max_levels 2", "vcycle", None, g_med,
             warm_start(main_parts["medium"], 2)),
        ]
        for cell, run, preset, configure, graph, prepare in runs:
            for fn in counted:
                fn.launches = 0
            traced = run == "default, from METIS"
            if traced:
                telemetry.enable()
            _native.EVENT_LOG = {}
            _, solver = run_main(
                cell, graph, kp, counted, dev, metrics,
                device_graph_from_host, torch, preset,
                EXPECTED_FILE_CUTS[(cell, run)], configure, run,
                check_graph=graphs[cell][0], prepare=prepare)
            torch.cuda.synchronize()
            summary = None
            if traced:
                path = os.path.join(tmp, "run.report.json")
                write_run_report(path)
                with open(path) as f:
                    summary = check_report(solver, json.load(f))
                telemetry.disable()
            log, _native.EVENT_LOG = _native.EVENT_LOG, None
            run_ms = {name: sum(a.elapsed_time(b) for a, b in ev)
                      for name, ev in log.items()}
            launches = {fn.__name__: fn.launches for fn in counted}
            # the large graph's levels take sort2, and so does the
            # v-cycle's restricted LP (it passes no level statistics to
            # the engine choice, in both packages): neither reaches K3
            needed = path_kernels[:2] if (
                cell == "large" or run.startswith("vcycle")) else path_kernels
            for fn in needed:
                if launches[fn.__name__] <= 0:
                    fail(f"{cell}/{run}: kernel {fn.__name__} was never "
                         "launched")
            results[f"{cell}/{run}"] = (launches, run_ms)
            print(json.dumps({
                "file_path": f"{cell}/{run}", "launches": launches,
                "path_ms": run_ms, "report": summary, "card": CARD}),
                flush=True)

        results.update(run_stream_paths(
            graphs, kp, counted, path_kernels, dev, metrics,
            device_graph_from_host, torch,
            runs=[("large", "external, lazy compressed", *STREAM_RUNS[
                "external"], EXPECTED_FILE_CUTS[
                ("large", "external, lazy compressed")], lazy)]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return results


def budget_ctx(budget):
    """A configure(ctx) that declares a device-memory budget (the memory
    governor's; no scheme change)."""
    def configure(ctx):
        ctx.resilience.memory_budget = float(budget)
    return configure


def rb_refined(ctx):
    from kaminpar_tpu_torch.context import PartitioningMode

    ctx.partitioning.mode = PartitioningMode.RB
    ctx.partitioning.rb_enable_kway_toplevel_refinement = True


def with_checkpoints(directory, resume=False, configure=None):
    """A configure(ctx) that arms checkpoints in `directory` (after
    `configure`)."""
    def wrapped(ctx):
        if configure is not None:
            configure(ctx)
        ctx.resilience.checkpoint_dir = directory
        ctx.resilience.resume = resume
    wrapped.env = getattr(configure, "env", {})
    return wrapped


def hard_stop(kp, preset, graph, k, stop, configure, device) -> None:
    """Run until KAMINPAR_TPU_STOP_AT=`stop` (a hard stop, "...!") raises
    SimulatedPreemption right after that barrier's checkpoint landed."""
    from kaminpar_tpu_torch.resilience.checkpoint import SimulatedPreemption

    solver = kp.KaMinPar(preset, device=device)
    configure(solver.ctx)
    solver.set_graph(graph)
    try:
        with env_scope({"KAMINPAR_TPU_STOP_AT": stop}):
            solver.compute_partition(k=k, epsilon=0.03, seed=1)
    except SimulatedPreemption:
        return
    fail(f"{preset} on {device}: the hard stop at {stop} never fired")


# phase 10a: (run, preset, env, configure, hard stop to resume from)
SMALL_RESILIENCE_RUNS = [
    ("rung 1", "default", {"KAMINPAR_TPU_MEM_RUNG": 1}, None, None),
    ("rung 2", "default", {"KAMINPAR_TPU_MEM_RUNG": 2}, None, None),
    ("rung 3", "default", {"KAMINPAR_TPU_MEM_RUNG": 3}, None, None),
    ("rung 4", "default", {"KAMINPAR_TPU_MEM_RUNG": 4}, None, None),
    ("device-oom:nth=1", "default",
     {"KAMINPAR_TPU_FAULTS": "device-oom:nth=1"}, None, None),
    ("3,000,000-byte budget", "default", {}, budget_ctx(3_000_000), None),
    ("soft stop coarsen:1", "default",
     {"KAMINPAR_TPU_STOP_AT": "coarsen:1"}, None, None),
    ("soft stop initial", "default", {"KAMINPAR_TPU_STOP_AT": "initial"},
     None, None),
    ("soft stop uncoarsen:1", "default",
     {"KAMINPAR_TPU_STOP_AT": "uncoarsen:1"}, None, None),
    ("resume coarsen:1!", "default", {}, None, "coarsen:1!"),
    ("resume initial!", "default", {}, None, "initial!"),
    ("resume uncoarsen:1!", "default", {}, None, "uncoarsen:1!"),
    ("mtkahypar-kway, resume uncoarsen:1!", "mtkahypar-kway", {}, None,
     "uncoarsen:1!"),
    ("vcycle, resume vcycle:0!", "vcycle", {}, None, "vcycle:0!"),
    # contraction limit 160 and two streamed levels: a stream-coarsen:1
    # barrier exists
    ("external, resume stream-coarsen:1!", "default", {},
     external_ctx(chunk_edges=1 << 15, contraction_limit=160,
                  min_stream_levels=2), "stream-coarsen:1!"),
    ("rb, soft stop rb-toplevel", "default",
     {"KAMINPAR_TPU_STOP_AT": "rb-toplevel"}, rb_refined, None),
    ("terapart, compressed-stream:nth=1", "terapart",
     {"KAMINPAR_TPU_FAULTS": "compressed-stream:nth=1"}, None, None),
    ("bit-flip:partition:nth=1", "default",
     {"KAMINPAR_TPU_FAULTS": "bit-flip:partition:nth=1"}, None, None),
]
# the runs of phase 10a that must give phase 4's `default` partition
SMALL_EQUALS_DEFAULT = ("rung 1", "rung 2", "device-oom:nth=1",
                        "resume coarsen:1!", "resume initial!",
                        "resume uncoarsen:1!", "bit-flip:partition:nth=1")


def check_resilience_parity(g_small, small_default, kp, torch) -> None:
    """Phase 10a: the resilience layer at n = 2^14, k=8, on the CPU and
    on the card, each pair of partitions bitwise equal."""
    from kaminpar_tpu_torch import resilience

    tmp = tempfile.mkdtemp(prefix="kp-smoke-ckpt-")
    try:
        for run, preset, env, configure, stop in SMALL_RESILIENCE_RUNS:
            parts, summaries = {}, {}
            for device in ("cpu", "cuda"):
                resilience.reset()
                conf = configure or (lambda ctx: None)
                t0 = time.perf_counter()
                if stop is not None:
                    directory = os.path.join(tmp, f"{len(os.listdir(tmp))}")
                    hard_stop(kp, preset, g_small, 8, stop,
                              with_checkpoints(directory, False, configure),
                              device)
                    conf = with_checkpoints(directory, True, configure)
                solver = kp.KaMinPar(preset, device=device)
                conf(solver.ctx)
                RESILIENCE_EVENTS.clear()
                with env_scope(dict(getattr(configure, "env", {}), **env)):
                    parts[device] = solver.set_graph(
                        g_small).compute_partition(k=8, epsilon=0.03, seed=1)
                events = sorted({n for n, _ in RESILIENCE_EVENTS})
                # the barrier's pressure spills read the card's live bytes
                # (0 on the CPU): they are the one thing the devices may
                # differ in
                summaries[device] = (
                    [n for n in events if n not in (
                        "memory-pressure", "memory-spill", "memory-reload")],
                    solver.last_anytime)
                print(json.dumps({
                    "small_run": run, "device": device, "events": events,
                    "anytime": solver.last_anytime,
                    "rung": resilience.memory.summary().get("rung"),
                    "wall_s": round(time.perf_counter() - t0, 3)}),
                    flush=True)
                if not events:
                    fail(f"n=2^14 {run} on {device}: no resilience event")
            if not np.array_equal(parts["cpu"], parts["cuda"]):
                fail(f"n=2^14 {run}: CPU and CUDA partitions differ in "
                     f"{int((parts['cpu'] != parts['cuda']).sum())} nodes")
            if summaries["cpu"] != summaries["cuda"]:
                fail(f"n=2^14 {run}: CPU and CUDA events differ: "
                     f"{summaries}")
            if run in SMALL_EQUALS_DEFAULT and not np.array_equal(
                    parts["cuda"], small_default):
                fail(f"n=2^14 {run}: not phase 4's default partition")
            print(json.dumps({"small_parity": run,
                              "result": "bitwise-equal"}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_resilience_paths(graphs, main_parts, kp, counted, path_kernels, dev,
                         metrics, device_graph_from_host, torch) -> dict:
    """Phases 10b-10e at full width, k=16, eps=0.03, seed=1: every cell of
    EXPECTED_RESILIENCE_CUTS on the medium graph; checkpoint costs and a
    hard stop with resume on the large graph; a genuine CUDA out-of-memory
    error recovered by the ladder; the integrity sentinels' cost.  Returns
    the runs' (launches, path_ms) for the kernels line."""
    from kaminpar_tpu_torch import _native, resilience
    from kaminpar_tpu_torch.external import driver

    g_large, g_med = graphs["large"][0], graphs["medium"][0]
    tmp = tempfile.mkdtemp(prefix="kp-smoke-ckpt-")
    results = {}
    at_handoff = {}
    incore = driver.ExternalPartitioner._incore_partition

    def hooked(self, handoff):
        at_handoff["launches"] = {fn.__name__: fn.launches for fn in counted}
        return incore(self, handoff)

    def counted_run(cell, run, graph, expected, configure=None, env=None,
                    needed=path_kernels, quiet=False, preset="default"):
        for fn in counted:
            fn.launches = 0
        resilience.reset()
        at_handoff.clear()
        _native.EVENT_LOG = {}
        part, solver = run_main(cell, graph, kp, counted, dev, metrics,
                                device_graph_from_host, torch, preset,
                                expected, configure, run, quiet=quiet,
                                env=env)
        torch.cuda.synchronize()
        log, _native.EVENT_LOG = _native.EVENT_LOG, None
        launches = {fn.__name__: fn.launches for fn in counted}
        run_ms = {name: sum(a.elapsed_time(b) for a, b in ev)
                  for name, ev in log.items()}
        for fn in needed:
            if launches[fn.__name__] <= 0:
                fail(f"{cell}/{run}: kernel {fn.__name__} was never "
                     "launched")
        results[f"{cell}/{run}"] = (launches, run_ms)
        summary = resilience.memory.summary()
        print(json.dumps({
            "resilience_path": f"{cell}/{run}", "launches": launches,
            "path_ms": run_ms, "rung": summary.get("rung"),
            "events": sorted({n for n, _ in RESILIENCE_EVENTS}),
            "anytime": solver.last_anytime, "wall_s": solver.smoke_wall,
            "peak_allocated_bytes": solver.smoke_peak, "card": CARD}),
            flush=True)
        return part, solver

    driver.ExternalPartitioner._incore_partition = hooked
    try:
        # -- 10b. the medium graph's resilience cells
        medium_runs = {
            "rung 1": ({"KAMINPAR_TPU_MEM_RUNG": 1}, None),
            "24 MiB budget": ({}, budget_ctx(24 << 20)),
            "device-oom:nth=1": (
                {"KAMINPAR_TPU_FAULTS": "device-oom:nth=1"}, None),
            "resume uncoarsen:1!": ({}, "resume"),
            "16 MiB budget": ({}, budget_ctx(16 << 20)),
            "rung 4": ({"KAMINPAR_TPU_MEM_RUNG": 4}, None),
            "soft stop coarsen:1": (
                {"KAMINPAR_TPU_STOP_AT": "coarsen:1"}, None),
            "soft stop initial": ({"KAMINPAR_TPU_STOP_AT": "initial"}, None),
            "soft stop uncoarsen:1": (
                {"KAMINPAR_TPU_STOP_AT": "uncoarsen:1"}, None),
            "soft stop coarsen:3": (
                {"KAMINPAR_TPU_STOP_AT": "coarsen:3"}, None),
        }
        for run, (env, configure) in medium_runs.items():
            expected, is_default = EXPECTED_RESILIENCE_CUTS[run]
            needed = path_kernels
            if run == "rung 4" or (run.startswith("soft stop")
                                   and run != "soft stop coarsen:3"):
                # host-only, or wound down before (some of) refinement
                needed = ()
            elif run == "16 MiB budget":
                needed = path_kernels[:1]
            elif run.startswith("resume"):
                # the fused K3 runs in level 0's LP clustering only (the
                # scatter engine), before the first barrier: a resumed
                # run skips it, in both packages
                needed = path_kernels[:2]
            if configure == "resume":
                directory = os.path.join(tmp, "medium")
                hard_stop(kp, "default", g_med, K_MAIN, "uncoarsen:1!",
                          with_checkpoints(directory), "cuda")
                configure = with_checkpoints(directory, resume=True)
            part, solver = counted_run("medium", run, g_med, expected,
                                       configure, env, needed)
            if is_default and not np.array_equal(part, main_parts["medium"]):
                fail(f"medium/{run}: not phase 5's medium partition")
            rung = resilience.memory.summary().get("rung", 0)
            want_rung = {"rung 1": 1, "24 MiB budget": 2,
                         "device-oom:nth=1": 1, "16 MiB budget": 3,
                         "rung 4": 4}.get(run, 0)
            if rung != want_rung:
                fail(f"medium/{run}: ended at rung {rung}, not {want_rung}")
            if run == "16 MiB budget" and at_handoff["launches"][
                    "gather_i32"] <= 0:
                fail("medium/16 MiB budget: K1 never launched in rung 3's "
                     "stream")
            stopped = run.startswith("soft stop") and run != (
                "soft stop coarsen:3")
            if stopped != bool(solver.last_anytime):
                fail(f"medium/{run}: anytime {solver.last_anytime}")

        # -- 10c. checkpoint writes on the large graph, hard stop, resume
        directory = os.path.join(tmp, "large")
        part, solver = counted_run(
            "large", "checkpointed", g_large, EXPECTED_CUTS["large"],
            with_checkpoints(directory), needed=path_kernels[:2])
        writes = [a for n, a in RESILIENCE_EVENTS
                  if n == "checkpoint" and "bytes" in a]
        print(json.dumps({
            "checkpoint_cost": "large", "writes": len(writes),
            "bytes": sum(a["bytes"] for a in writes),
            "wall_s": round(sum(a["wall_s"] for a in writes), 4),
            "per_barrier": [(a["stage"], a["level"], a["bytes"],
                             a["wall_s"]) for a in writes],
            "run_wall_s": solver.smoke_wall, "card": CARD}), flush=True)
        if not np.array_equal(part, main_parts["large"]):
            fail("large/checkpointed: not phase 5's large partition")
        shutil.rmtree(directory, ignore_errors=True)
        hard_stop(kp, "default", g_large, K_MAIN, "uncoarsen:1!",
                  with_checkpoints(directory), "cuda")
        part, _ = counted_run("large", "resume uncoarsen:1!", g_large,
                              EXPECTED_CUTS["large"],
                              with_checkpoints(directory, resume=True),
                              needed=path_kernels[:2])
        if not np.array_equal(part, main_parts["large"]):
            fail("large/resume uncoarsen:1!: not phase 5's large partition")

        # -- 10d. a genuine CUDA out-of-memory error
        results.update(check_real_oom(g_large, main_parts, counted_run,
                                      resilience, torch))

        # -- 10e. the integrity sentinels' cost
        walls = {}
        for run, env in (("integrity off", {"KAMINPAR_TPU_INTEGRITY": "0"}),
                         ("integrity on", {})):
            part, solver = counted_run("large", run, g_large,
                                       EXPECTED_CUTS["large"], env=env,
                                       needed=path_kernels[:2], quiet=True)
            if not np.array_equal(part, main_parts["large"]):
                fail(f"large/{run}: not phase 5's large partition")
            walls[run] = solver.smoke_wall
        integrity = resilience.integrity.summary()
        print(json.dumps({
            "integrity_cost": "large", "walls_s": walls,
            "checks": integrity["checks"],
            "sentinel_s": integrity["wall_s"],
            "overhead_pct": resilience.integrity.overhead_pct(
                walls["integrity on"]), "card": CARD}), flush=True)
    finally:
        driver.ExternalPartitioner._incore_partition = incore
        shutil.rmtree(tmp, ignore_errors=True)
    return results


def check_real_oom(g_large, main_parts, counted_run, resilience,
                   torch) -> dict:
    """Phase 10d: measure the peak allocation of forced rungs 0 and 1 on
    the large graph, cap the process's allocator between the two, and run
    `default` with no budget: rung 0 must run out of memory for real (a
    torch.OutOfMemoryError, not an injected fault), the ladder must
    record it and finish at a higher rung, with that rung's partition."""
    results = {}
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peaks, parts = {}, {}
    for rung in (0, 1):
        # rung 1's tight pads give the large graph a cut of its own, the
        # JAX package's under the same forced rung (EXPECTED_LARGE_RUNG1)
        run = f"rung {rung}"
        parts[rung], solver = counted_run(
            "large", run, g_large,
            EXPECTED_CUTS["large"] if rung == 0 else EXPECTED_LARGE_RUNG1[0],
            env={"KAMINPAR_TPU_MEM_RUNG": rung}, needed=(),
            quiet=rung == 0)
        peaks[rung] = solver.smoke_peak - base
    digest = hashlib.sha256(
        np.ascontiguousarray(parts[1], dtype=np.int32).tobytes()).hexdigest()
    if digest != EXPECTED_LARGE_RUNG1[1]:
        fail(f"large: forced rung 1's partition (sha256 {digest}) is not "
             "the JAX package's")
    if peaks[1] >= peaks[0]:
        fail(f"large: rung 1 peaks at {peaks[1]} bytes, rung 0 at "
             f"{peaks[0]}: tight pads saved nothing")
    total = torch.cuda.get_device_properties(0).total_memory
    cap = base + (peaks[0] + peaks[1]) // 2
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        part, solver = counted_run("large", "capped, no budget", g_large,
                                   None, needed=())
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    real = [a for n, a in RESILIENCE_EVENTS
            if n == "degraded" and a.get("site") == "device-oom"]
    rung = resilience.memory.summary().get("rung", 0)
    print(json.dumps({
        "real_oom": "large", "peak_bytes": peaks, "base_bytes": base,
        "cap_bytes": cap, "total_bytes": total, "final_rung": rung,
        "degraded": real, "wall_s": solver.smoke_wall, "card": CARD}),
        flush=True)
    if not real or any(a.get("injected") for a in real):
        fail("large, capped: no genuine CUDA out-of-memory error was "
             "recovered by the ladder")
    if "out of memory" not in real[0]["detail"]:
        fail(f"large, capped: the first rung change was {real[0]}")
    if rung > 2:
        fail(f"large, capped: the ladder went on to rung {rung}: the failed "
             "attempt's memory was not released")
    if rung not in parts:
        parts[rung], _ = counted_run(
            "large", f"rung {rung}", g_large, None,
            env={"KAMINPAR_TPU_MEM_RUNG": rung}, needed=())
    if not np.array_equal(part, parts[rung]):
        fail(f"large, capped: not the partition of forced rung {rung}")
    return results


def check_k3(core, kp, gather, rating, segments, Coarsener,
             device_graph_from_host, rng, dev, torch) -> list:
    """K3 on the medium graph's level 0: the standalone kernel on the
    slot table of scatter_slot_ratings, and the fused kernel on the level's
    spans, each held against its twin; the fused one also at num_slots 4
    (contested rows) and 48 (no power of two), on hub rows of 45k edges
    and on delta spans cut at the buffer.  Returns both kernels' entries
    of the JSON line."""
    dg = device_graph_from_host(core, dev)
    ctx = kp.context_from_preset("default")
    ctx.partition.setup(core, k=K_MAIN, epsilon=0.03)
    lp_cfg = Coarsener(ctx, dg, core.n)._level_lp_cfg(dg)
    if lp_cfg.rating != "scatter":
        fail(f"medium graph level 0 takes {lp_cfg.rating}, not scatter")
    num_slots, salt = lp_cfg.num_slots, 12345
    ids = dg.node_ids()
    spans = (dg.row_ptr[:-1], dg.row_ptr[1:])
    nb = gather.gather_i32(ids, dg.dst)
    slot_label, slot_w, _ = rating.scatter_slot_ratings(
        dg.src, nb, dg.edge_w, dg.n_pad, num_slots, salt, spans=spans,
    )
    # cluster weights in [cap - 2, cap] (unit node weights: about a third
    # of the labels is infeasible), and every 37th at INT32_MAX, where
    # cw + node_w wraps negative in int32 and so passes the mask
    cap_value, i32_max = 64, np.iinfo(np.int32).max

    def around_cap(n):
        cw_np = rng.integers(cap_value - 2, cap_value + 1, n, dtype=np.int32)
        cw_np[::37] = i32_max
        return (torch.from_numpy(cw_np).to(dev),
                torch.full((n,), cap_value, dtype=torch.int32, device=dev))

    cw, cap = around_cap(dg.n_pad)

    def blind_check(what, best_fit, best_nofit):
        masked = int((best_fit != best_nofit).sum())
        wrapped = int(((best_fit >= 0)
                       & (cw[best_fit.clamp(min=0)] == i32_max)).sum())
        if masked == 0 or wrapped == 0:
            fail(f"{what} check is blind: the mask changed {masked} rows, "
                 f"{wrapped} rows chose a wrapped-feasible label")
        return masked, wrapped

    # -- standalone
    args3 = (slot_label, slot_w, ids, cw, dg.node_w, cap, 0x2545F491)
    outs = rating.best_from_slots(*args3)
    refs = rating.best_from_slots_twin(*args3)
    outs_nf = rating.best_from_slots(*args3, require_fit=False)
    refs_nf = rating.best_from_slots_twin(*args3, require_fit=False)
    torch.cuda.synchronize()
    for o, r in zip(outs + outs_nf, refs + refs_nf):
        if not torch.equal(o, r):
            fail("K3 best_from_slots disagrees with its twin")
    masked, wrapped = blind_check("K3", outs[0], outs_nf[0])
    print(json.dumps({"k3_masked_rows": masked, "k3_wrapped_rows": wrapped}),
          flush=True)
    rows, S = slot_label.shape
    b, by, per_launch = cost_bound(rating.best_from_slots_cost(slot_label))
    ms, _, ms_by = device_ms(lambda: rating.best_from_slots(*args3), torch)
    standalone = {
        "name": "best_from_slots", "route": "cuda",
        "source": "kaminpar_tpu_torch/csrc/best_from_slots.cu",
        "replaces": "kaminpar_tpu/ops/rating.py:377",
        "max_abs_err": max(max_abs_err(o, r) for o, r in zip(outs, refs)),
        "ms": ms, "ms_by": ms_by,
        "call_ms": time_ms(lambda: rating.best_from_slots(*args3), torch),
        "plain_ms": time_ms(
            lambda: rating.best_from_slots_twin(*args3), torch),
        "bound_ms": b, "bound_by": by,
        "bytes_per_launch": per_launch,
        "cost_function": COST_FUNCTIONS["best_from_slots"],
        "library_ms": None,
        "shape": {"graph": "medium", "rows": rows, "slots": S},
        "sweep": sweep_k3(rating, torch, dev),
    }
    del outs, refs, outs_nf, refs_nf
    print_k3_vs_parent("medium, int32", ms)

    # -- fused: the level's spans, then the edge cases
    def fused_case(what, args, blind=False, contested=False):
        err = 0
        out = {}
        for fit in (True, False):
            a = rating.scatter_best_from_slots(*args, require_fit=fit)
            r = rating.scatter_best_from_slots_twin(*args, require_fit=fit)
            torch.cuda.synchronize()
            for x, y in zip(a, r):
                if not torch.equal(x, y):
                    fail(f"fused K3 disagrees with its twin: {what}, "
                         f"require_fit={fit}")
            err = max(err, *(max_abs_err(x, y) for x, y in zip(a, r)))
            out[fit] = a
        if blind:
            blind_check(f"fused K3 ({what})", out[True][0], out[False][0])
        unrated = int((~out[True][3]).sum())
        if contested and unrated == 0:
            fail(f"fused K3 check is blind ({what}): every row fully rated")
        return err, unrated

    level = (*spans, dg.dst, dg.edge_w, ids, cw, dg.node_w, cap)
    fused_args = (*level, num_slots, salt)
    err, unrated = fused_case(f"level 0, num_slots {num_slots}", fused_args,
                              blind=True)
    err4, unrated4 = fused_case("level 0, num_slots 4", (*level, 4, salt),
                                blind=True, contested=True)
    # a num_slots that is not a power of two takes `%` instead of a mask
    err48, _ = fused_case("level 0, num_slots 48", (*level, 48, salt))
    # a delta round over 60% of the rows in a buffer of a quarter of the
    # slots (LP's delta size): the spans run past the buffer
    active = torch.from_numpy(rng.random(dg.n_pad) < 0.6).to(dev)
    _, _, edge_id, valid, start, end = segments.expand_active_rows(
        dg.row_ptr, dg.degrees, active, dg.m_pad // 4)
    if int(end.max()) <= dg.m_pad // 4:
        fail("fused K3 delta case: the spans do not run past the buffer")
    eid = edge_id.clamp(0, dg.m_pad - 1)
    dst_b = torch.where(valid, dg.dst[eid], dg.n_pad - 1)
    w_b = torch.where(valid, dg.edge_w[eid], 0)
    err_d, _ = fused_case("delta spans cut at the buffer",
                          (start, end, dst_b, w_b, ids, cw, dg.node_w, cap,
                           num_slots, salt))
    # hub rows of 45k edges (the block-per-row kernel) beside light rows
    deg = rng.integers(0, 24, 1 << 16)
    deg[[7, 31_000, 65_000]] = (45_000, 44_904, 41_000)
    deg[-4000:] = 0
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    hub_m = int(row_ptr[-1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    hub_cw, hub_cap = around_cap(1 << 16)
    hub_args = (t(row_ptr[:-1]), t(row_ptr[1:]),
                t(rng.integers(0, 1 << 16, hub_m)),
                t(rng.integers(0, 4, hub_m)),
                t(rng.integers(0, 1 << 16, 1 << 16)), hub_cw,
                t(np.ones(1 << 16)), hub_cap, num_slots, salt)
    err_h, _ = fused_case("hub rows", hub_args)
    print(json.dumps({"fused_k3_cases": {
        "level0_unrated_rows": unrated, "slots4_unrated_rows": unrated4,
        "delta": "ok", "hub_rows": [45_000, 44_904, 41_000]}}), flush=True)

    def replaced():  # the scatter engine's chain before the fused K3
        sl, sw, _ = rating.scatter_slot_ratings(
            dg.src, nb, dg.edge_w, dg.n_pad, num_slots, salt, spans=spans)
        return rating.best_from_slots(sl, sw, ids, cw, dg.node_w, cap, salt)

    b, by, per_launch = cost_bound(
        rating.scatter_best_from_slots_cost(*fused_args))
    hub_b, _, _ = cost_bound(rating.scatter_best_from_slots_cost(*hub_args))
    ms, split, ms_by = device_ms(
        lambda: rating.scatter_best_from_slots(*fused_args), torch)
    hub_ms, hub_split, _ = device_ms(
        lambda: rating.scatter_best_from_slots(*hub_args), torch)
    fused = {
        "name": "scatter_best_from_slots", "route": "cuda",
        "source": "kaminpar_tpu_torch/csrc/best_from_slots.cu",
        "replaces": "kaminpar_tpu/ops/rating.py:377",
        "max_abs_err": max(err, err4, err48, err_d, err_h),
        "ms": ms, "ms_by": ms_by,
        "call_ms": time_ms(
            lambda: rating.scatter_best_from_slots(*fused_args), torch),
        "plain_ms": time_ms(
            lambda: rating.scatter_best_from_slots_twin(*fused_args), torch,
            reps=5),
        "bound_ms": b, "bound_by": by,
        "bytes_per_launch": per_launch,
        "cost_function": COST_FUNCTIONS["scatter_best_from_slots"],
        "library_ms": None,
        "split_ms": split,
        "replaced_ms": device_ms(replaced, torch, reps=5)[0],
        "replaced_call_ms": time_ms(replaced, torch, reps=5),
        "hub_ms": hub_ms, "hub_split_ms": hub_split,
        "hub_bound_ms": hub_b,
        "shape": {"graph": "medium", "rows": dg.n_pad, "edges": dg.m,
                  "num_slots": num_slots, "hub_edges": hub_m},
    }
    return [standalone, fused]


# ---------------------------------------------------------------------------
# the standalone K3's sweep, and its time beside the design it replaced
# ---------------------------------------------------------------------------

# slots per row of the sweep's tables: 8, 64, 128 and 512 take the
# kernel's 16-byte vectors (lane groups of 1, 8, 16 and 32 lanes, 512 in
# two chunks), 6 (num_slots 3) its 8-byte vectors, 7 its scalar loads
K3_SWEEP_SLOTS = (8, 64, 128, 512, 6, 7)
# rows of each table: a prime, so no lane group's rows per block divide it
K3_SWEEP_ROWS = 4099
# the device ms of the standalone K3's earlier design (a warp a row,
# 4-byte loads, lookups before the comparison; csrc/best_from_slots.cu at
# commit 0ad4416) on an NVIDIA H100 80GB HBM3 at 700.00 W, at the shapes
# this script times (PERF.md, section 6: medium and the dist shard timed
# in turns with this design); printed beside this run's times, not
# measured here
K3_PARENT_MS = {"medium, int32": 0.0511, "heavy medium, int64": 0.056,
                "dist shard, label_range": 0.0084}


def kernel_registers(_native) -> dict:
    """source -> kernel -> {"REG", "STACK", "SHARED", "LOCAL"} of the
    package's built CUDA libraries, as `cuobjdump -res-usage` reads them
    (LOCAL: a thread's bytes of local memory, spills included);
    {"error": ...} where it cannot read them."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_native._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {"error": "no cuobjdump beside nvcc"}
    found = {}
    for src in _native.SOURCES:
        res = subprocess.run([tool, "-res-usage", str(_native._lib_path(src))],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            found[src] = {"error": (res.stderr or res.stdout)[-300:]}
            continue
        names, usage = [], []
        for name, fields in re.findall(
                r"Function (\S+):\s*\n\s*(REG:.*)", res.stdout):
            names.append(name)
            usage.append({k: int(v) for k, v in re.findall(
                r"(REG|STACK|SHARED|LOCAL):(\d+)", fields)})
        if shutil.which("c++filt") and names:
            plain = subprocess.run(["c++filt"], input="\n".join(names),
                                   capture_output=True, text=True).stdout
            short = [re.sub(r"\(anonymous namespace\)::|^void ", "",
                            line).split("(")[0]
                     for line in plain.splitlines()]
            if len(short) == len(names):
                names = short
        found[src] = dict(zip(names, usage))
    return found


def print_k3_vs_parent(shape: str, ms: float) -> None:
    """This run's standalone K3 device ms at `shape`, on a line of its own
    beside the earlier design's recorded time there."""
    print(json.dumps({"k3_vs_parent": {
        "shape": shape, "ms": ms, "parent_ms_recorded": K3_PARENT_MS[shape],
        "card": CARD}}), flush=True)


def sweep_k3(rating, torch, dev) -> dict:
    """The standalone K3 bitwise against its twin on synthetic slot tables
    in this process's weight dtype (int64 in phase 15): K3_SWEEP_ROWS rows
    of each S in K3_SWEEP_SLOTS, and of S = 128 with the tables' base 4
    bytes past a 16-byte boundary (the scalar path).  One slot in five is
    empty, one row in seven all empty, half the rows hold their own
    label; weights lie in [0, 4) (plus 2^33 in int64), so the hash breaks
    ties; cluster weights lie just under the cap and every 37th at the
    weight type's max, where the fit test wraps.  Each table with
    require_fit on and off, plain, under communities=, label_range= and
    both.  Fails on a difference, or when no row had a tie, an empty row,
    a wrapped fit or a winner that a mask changed; returns the counts."""
    from kaminpar_tpu_torch.dtypes import WEIGHT_DTYPE

    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    n, wdt = K3_SWEEP_ROWS, WEIGHT_DTYPE
    wmax = torch.iinfo(wdt).max
    base = (1 << 33) if wdt == torch.int64 else 0
    cap = torch.full((n,), base + 64, dtype=wdt, device=dev)
    cw_np = base + 64 - rng.integers(0, 4, n)
    cw_np[::37] = wmax
    cw = torch.from_numpy(cw_np).to(dev, wdt)
    node_w = torch.from_numpy(rng.integers(1, 3, n)).to(dev, wdt)
    comm = torch.from_numpy(rng.integers(0, 3, n)).to(dev, torch.int32)
    masks = {"plain": {}, "communities": {"communities": comm},
             "label_range": {"label_range": (n // 4, 3 * n // 4)}}
    masks["both"] = dict(masks["communities"], **masks["label_range"])
    totals = {"tables": 0, "calls": 0, "tied_rows": 0, "empty_rows": 0,
              "wrapped_rows": 0, "fit_masked_rows": 0,
              "communities_masked_rows": 0, "label_range_masked_rows": 0}
    for S in K3_SWEEP_SLOTS + ("128, base off 16 B",):
        s, off = (128, 1) if isinstance(S, str) else (S, 0)
        size = n * s + off
        lab = rng.integers(0, n, size).astype(np.int32)
        lab[rng.random(size) < 0.2] = -1
        w = np.where(lab >= 0, base + rng.integers(0, 4, size), 0)
        sl = torch.from_numpy(lab).to(dev)[off:].view(n, s)
        sw = torch.from_numpy(w).to(dev, wdt)[off:].view(n, s)
        sl[::7] = -1
        sw[::7] = 0
        if sl.data_ptr() % 16 == 0 and off:
            fail("K3 sweep: the offset table is 16-byte aligned")
        pick = sl[torch.arange(n, device=dev),
                  torch.from_numpy(rng.integers(0, s, n)).to(dev)]
        labels = torch.from_numpy(rng.integers(0, n, n)).to(dev, torch.int32)
        labels = torch.where(
            (pick >= 0) & torch.from_numpy(rng.random(n) < 0.5).to(dev),
            pick, labels)
        args = (sl, sw, labels, cw, node_w, cap, int(rng.integers(0, 2**31)))
        best = {}
        for fit in (True, False):
            for what, kw in masks.items():
                out = rating.best_from_slots(*args, require_fit=fit, **kw)
                ref = rating.best_from_slots_twin(*args, require_fit=fit,
                                                  **kw)
                torch.cuda.synchronize()
                for o, r in zip(out, ref):
                    if o.dtype != r.dtype or not torch.equal(o, r):
                        fail(f"K3 sweep: the kernel disagrees with its twin "
                             f"at S = {S}, require_fit={fit}, {what}, "
                             f"{wdt}")
                best[fit, what] = out
                totals["calls"] += 1
        free_best, free_w, _ = best[False, "plain"]
        feas = (sl >= 0) & (sl != labels[:, None])
        at = feas & (sw == free_w[:, None])
        big = torch.iinfo(torch.int32).max
        totals["tied_rows"] += int((
            torch.where(at, sl, big).min(dim=1).values
            != torch.where(at, sl, -1).max(dim=1).values).sum())
        totals["empty_rows"] += int((sl < 0).all(dim=1).sum())
        fit_best = best[True, "plain"][0]
        totals["wrapped_rows"] += int(
            ((fit_best >= 0) & (cw[fit_best.clamp(min=0)] == wmax)).sum())
        totals["fit_masked_rows"] += int((fit_best != free_best).sum())
        for what in ("communities", "label_range"):
            totals[f"{what}_masked_rows"] += int(
                (best[False, what][0] != free_best).sum())
        totals["tables"] += 1
    blind = [k for k, v in totals.items() if v == 0]
    if blind:
        fail(f"K3 sweep is blind: no row counted in {blind}")
    totals["weights"] = str(wdt).replace("torch.", "")
    totals["seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps({"k3_sweep": totals}), flush=True)
    return totals


def check_k3_communities(core, core_part, kp, rating, Coarsener,
                         device_graph_from_host, dev, torch) -> dict:
    """The fused K3 with communities= at the medium graph's level 0 (every
    node its own cluster, the level's cluster weight cap), the communities
    a 16-block partition of the graph: bitwise against its twin, some
    rows' best label changed by the mask, and timed beside the same call
    without communities, in turns (without, with, with, without)."""
    dg = device_graph_from_host(core, dev)
    ctx = kp.context_from_preset("default")
    ctx.partition.setup(core, k=K_MAIN, epsilon=0.03)
    num_slots = Coarsener(ctx, dg, core.n)._level_lp_cfg(dg).num_slots
    mcw = ctx.coarsening.max_cluster_weight(core.n, core.total_node_weight,
                                            ctx.partition)
    comm_np = np.full(dg.n_pad, K_MAIN, dtype=np.int32)  # pad: its own
    comm_np[: core.n] = core_part
    comm = torch.from_numpy(comm_np).to(dev)
    cap = torch.full((dg.n_pad,), mcw, dtype=torch.int32, device=dev)
    args = (dg.row_ptr[:-1], dg.row_ptr[1:], dg.dst, dg.edge_w,
            dg.node_ids(), dg.node_w, dg.node_w, cap, num_slots, 4242)
    err = 0
    for fit in (True, False):
        out = rating.scatter_best_from_slots(*args, require_fit=fit,
                                             communities=comm)
        ref = rating.scatter_best_from_slots_twin(*args, require_fit=fit,
                                                  communities=comm)
        torch.cuda.synchronize()
        for x, y in zip(out, ref):
            if not torch.equal(x, y):
                fail(f"fused K3 with communities disagrees with its twin "
                     f"(require_fit={fit})")
            err = max(err, max_abs_err(x, y))
    with_comm = rating.scatter_best_from_slots(*args, communities=comm)
    free = rating.scatter_best_from_slots(*args)
    changed = int((with_comm[0] != free[0]).sum())
    if changed <= 0:
        fail("fused K3 with communities: the mask changed no row's best")
    times = {"without": [], "with": []}
    splits = {}
    for which in ("without", "with", "with", "without"):
        kw = {"communities": comm} if which == "with" else {}
        ms, split, _ = device_ms(
            lambda: rating.scatter_best_from_slots(*args, **kw), torch)
        times[which].append(ms)
        splits[which] = split
    result = {"rows": dg.n_pad, "edges": dg.m, "num_slots": num_slots,
              "rows_changed": changed, "max_abs_err": err,
              "ms_without": times["without"], "ms_with": times["with"],
              "split_without": splits["without"],
              "split_with": splits["with"]}
    print(json.dumps({"fused_k3_communities": result}), flush=True)
    return result


def check_k2_edge_cases(dg, gather, segments, rng, dev, torch) -> None:
    """K2 against its twin where its design has edges: hub rows of 45k
    edges cut over many blocks, a k beyond the shared-memory design, and a
    delta round's compacted spans cut at the end of the buffer."""
    deg = rng.integers(0, 24, 1 << 16)
    deg[[7, 31_000, 65_000]] = (45_000, 44_904, 41_000)
    deg[-4000:] = 0
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    m = int(row_ptr[-1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    hub_spans = (t(row_ptr[:-1]), t(row_ptr[1:]))
    hub_dst = t(rng.integers(0, 1 << 16, m + 1000))
    hub_w = t(rng.integers(0, 4, m + 1000))
    cases = []
    for k in (2, 16, 256, 2048, 4096):
        labels = t(rng.integers(-1, k + 1, 1 << 16))
        cases.append((f"hub rows, k={k}",
                      (*hub_spans, hub_dst, hub_w, labels, 1 << 16, k)))
    # a delta round over 60% of the large graph's rows, in a buffer of a
    # quarter of its slots (jet's and LP's delta size)
    active = t(rng.random(dg.n_pad) < 0.6).bool()
    num_slots = dg.m_pad // 4
    _, _, edge_id, valid, start, end = segments.expand_active_rows(
        dg.row_ptr, dg.degrees, active, num_slots)
    if int(end.max()) <= num_slots:
        fail("K2 delta case: the spans do not run past the buffer")
    eid = edge_id.clamp(0, dg.m_pad - 1)
    dst_b = torch.where(valid, dg.dst[eid], dg.n_pad - 1)
    w_b = torch.where(valid, dg.edge_w[eid], 0)
    labels = t(rng.integers(0, 16, dg.n_pad))
    cases.append(("delta spans cut at the buffer",
                  (start, end, dst_b, w_b, labels, dg.n_pad, 16)))
    for what, args in cases:
        ref = gather.dense_block_ratings_twin(*args)
        out = gather.dense_block_ratings(*args)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"K2 dense_block_ratings disagrees with its twin: {what}")
    print(json.dumps({"k2_edge_cases": [w for w, _ in cases]}), flush=True)


def run_main(name, graph, kp, counted, dev, metrics, device_graph_from_host,
             torch, preset, expected_cut, configure=None, run=None,
             check_graph=None, prepare=None, quiet=True, env=None):
    """Partition one graph with `preset` (after `configure(ctx)`, and
    `prepare(solver)` once the graph is set) through the public entry
    point and check the result against `expected_cut`, recounted on
    `check_graph` (a HostGraph of the same graph; `graph` by default;
    `expected_cut` None: a cut with no pin);
    prints its cut, imbalance, walls and launches and returns the
    partition and the solver (with the run's wall, `smoke_wall`, and its
    peak device allocation, `smoke_peak`).  `env` (and `configure.env`)
    are set while it computes.  A `quiet` run must leave no degradation,
    rung, wind-down or integrity-violation event."""
    from kaminpar_tpu_torch import _native

    from kaminpar_tpu_torch import native

    before = {fn.__name__: fn.launches for fn in counted}
    fm_calls = native.fm_refine.calls
    solver = kp.KaMinPar(preset, device="cuda")
    if configure is not None:
        configure(solver.ctx)
    t0 = time.perf_counter()
    solver.set_graph(graph)
    set_graph_s = time.perf_counter() - t0
    if prepare is not None:
        prepare(solver)
    RESILIENCE_EVENTS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with env_scope(dict(getattr(configure, "env", {}), **(env or {}))):
        partition = solver.compute_partition(k=K_MAIN, epsilon=0.03, seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    solver.smoke_wall = wall
    solver.smoke_peak = torch.cuda.max_memory_allocated()
    if quiet and loud_events():
        fail(f"{preset} ({name}, {run}): a run that neither injects, "
             f"budgets nor stops left events {loud_events()[:3]}")
    fm_calls = native.fm_refine.calls - fm_calls
    graph = graph if check_graph is None else check_graph
    if partition.shape != (graph.n,) or partition.min() < 0 or (
        partition.max() >= K_MAIN
    ):
        fail(f"main path ({name}): partition out of range")
    bw = np.bincount(partition, weights=graph.node_weight_array(),
                     minlength=K_MAIN).astype(np.int64)
    caps = np.asarray(solver.ctx.partition.unrelaxed_max_block_weights)
    if (bw > caps).any():
        fail(f"main path ({name}): block weights {bw.tolist()} over the "
             f"caps {caps.tolist()}")
    full = device_graph_from_host(graph, dev)
    part_pad = torch.zeros(full.n_pad, dtype=torch.int32, device=dev)
    part_pad[: graph.n] = torch.from_numpy(partition).to(dev)
    before_cut = {fn.__name__: fn.launches for fn in counted}
    log, _native.EVENT_LOG = _native.EVENT_LOG, None
    cut_dev = int(metrics.edge_cut(full, part_pad))
    _native.EVENT_LOG = log
    for fn in counted:  # the check's own gathers are not the path's
        fn.launches = before_cut[fn.__name__]
    src = graph.edge_sources()
    cut_host = int(graph.edge_weight_array()[
        partition[src] != partition[graph.adjncy]].sum() // 2)
    if cut_dev != cut_host:
        fail(f"main path ({name}): device cut {cut_dev} != host cut "
             f"{cut_host}")
    if expected_cut is not None and cut_host != expected_cut:
        fail(f"{preset} ({name}): cut {cut_host}, the pinned cut is "
             f"{expected_cut}")
    perfect = -(-graph.total_node_weight // K_MAIN)
    print(json.dumps({
        "main_path": name, "preset": run or preset, "pinned": expected_cut,
        "set_graph_s": set_graph_s,
        "n": graph.n, "m": graph.m, "k": K_MAIN,
        "ip_s": solver.last_timings.get("initial-partitioning"),
        "cut": cut_host, "imbalance": float(bw.max() / perfect - 1.0),
        "gate": solver.last_gate,
        "wall_s": wall, "phase_s": solver.last_timings,
        "at_s": round(time.perf_counter() - T_START, 1),
        "native_fm_calls": fm_calls,
        "levels": solver.last_levels,
        "launches": {fn.__name__: fn.launches - before[fn.__name__]
                     for fn in counted},
        "resilience_events": [n for n, _ in loud_events()],
        "card": CARD,
    }), flush=True)
    return partition, solver


# ---------------------------------------------------------------------------
# phase 11: dynamic sessions and the command lines
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
MEDIUM_SPEC = "gen:rmat;n=65536;m=600000;seed=3"
SMALL_SPEC = "gen:rmat;n=16384;m=120000;seed=3"
# the register partitions (phase 5's, committed to a session) and the
# session's chain digest after the commit; a partition digest is the
# first 16 hex digits of the sha256 of its int32 bytes, a chain digest
# the first 12 of the session's chain
DYNAMIC_REGISTER = {
    "medium": ("29eda37c6f9fce0f", "87d55db6ccd3"),
}
# bench.py's dynamic measurement (PERF.md section 4), k=16, eps=0.03,
# seed 1 for every step: synth_chain(graph, steps, seed=41,
# edge_churn=0.01), each step applied in place and repartitioned warm,
# then a cold twin (`default`) on the mutated graph.  Per step: drift
# (six decimals), warm cut, partition digest, chain digest after the
# commit, cold twin's cut (None: no twin).  The JAX package's CPU runs
EXPECTED_DYNAMIC = {
    "medium": [
        (0.004180, 249_508, "86d2c6b6afc816a7", "19955361abb2", 249_843),
        (0.004356, 249_450, "7613de733494efaa", "ac991ad9334f", 250_037),
        (0.004286, 249_456, "5542aef4870fce80", "dd32d967b87f", 249_181),
        (0.004336, 249_409, "0dc0e23a7ea7ae09", "e4ed1f3b2fcd", 251_622),
    ],
}
# the same chain on medium with ctx.dynamic.replicas = 2: drift, the
# (warm, cold replica at seed 2) cuts, the kept cut, its digest, the chain
EXPECTED_DYNAMIC_REPLICAS = [
    (0.004180, [249_508, 249_197], 249_197, "44592566f89fc52b",
     "21693108cd25"),
    (0.004359, [248_789, 250_445], 248_789, "6dd569a7efc2cd99",
     "6d805587b174"),
    (0.004266, [248_763, 249_028], 248_763, "4b6675a2fc471299",
     "fc230fd28cb9"),
    (0.004321, [248_726, 249_361], 248_726, "fdbc488c8097b4bb",
     "70f783d065df"),
]
# the JAX CLI on the medium chain's four batches (`--delta-batch`, step i
# at seed 1 + i): the DYNAMIC lines' cuts and the written partition
EXPECTED_CLI_CHAIN = ([250_236, 249_513, 249_416, 249_438, 249_408],
                      "6c17ca11be6f31f9")

C_PROGRAM = r"""
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include "ckaminpar_tpu.h"

/* chip_smoke.py's C program: partitions the CSR of a binary file
 * (n, m, xadj[n+1] int64, adjncy[m] int32, adjwgt[m] int32) with
 * `default` at k = argv[2], eps 0.03, seed 1, from a second thread when
 * argv[3] is given; prints the cut and one block id per line. */
static int64_t n, *xadj;
static int32_t *adjncy, *adjwgt, *part, k;
static int64_t cut = -2;
static kmp_partitioner *p;

static void *compute(void *arg) {
  (void)arg;
  cut = kmp_compute_partition(p, n, xadj, adjncy, NULL, adjwgt, k, 0.03,
                              part);
  return NULL;
}

int main(int argc, char **argv) {
  FILE *f = fopen(argv[1], "rb");
  int64_t m;
  if (!f || fread(&n, 8, 1, f) != 1 || fread(&m, 8, 1, f) != 1) return 5;
  xadj = malloc(8 * (n + 1));
  adjncy = malloc(4 * m);
  adjwgt = malloc(4 * m);
  part = malloc(4 * n);
  if (fread(xadj, 8, n + 1, f) != (size_t)(n + 1)) return 5;
  if (fread(adjncy, 4, m, f) != (size_t)m) return 5;
  if (fread(adjwgt, 4, m, f) != (size_t)m) return 5;
  fclose(f);
  k = atoi(argv[2]);
  p = kmp_create("default", 1);
  if (!p) return 2;
  if (argc > 3) {
    pthread_t t;
    pthread_create(&t, NULL, compute, NULL);
    pthread_join(t, NULL);
  } else {
    compute(NULL);
  }
  if (cut < 0) {
    fprintf(stderr, "%s\n", kmp_last_error(p));
    return 3;
  }
  printf("cut=%lld\n", (long long)cut);
  for (int64_t u = 0; u < n; ++u) printf("%d\n", part[u]);
  kmp_free(p);
  return 0;
}
"""


def part_digest(partition) -> str:
    return hashlib.sha256(
        np.asarray(partition, dtype=np.int32).tobytes()).hexdigest()[:16]


def pin(what, got, expected) -> None:
    """Fail unless `got` is the JAX package's `expected`."""
    if got != expected:
        fail(f"{what}: {got!r}, the JAX package's is {expected!r}")


def graph_copy(graph):
    """A new HostGraph object over the same arrays: a session stamps its
    identity onto the object it owns, never onto a shared one."""
    from kaminpar_tpu_torch.graphs.host import HostGraph

    return HostGraph(graph.xadj, graph.adjncy, graph.node_weights,
                     graph.edge_weights)


@contextlib.contextmanager
def counting(counted, torch, record):
    """Count `counted`'s launches from zero and their CUDA-event time over
    the block into `record` ("launches", "path_ms")."""
    from kaminpar_tpu_torch import _native

    for fn in counted:
        fn.launches = 0
    _native.EVENT_LOG = {}
    try:
        yield record
    finally:
        torch.cuda.synchronize()
        log, _native.EVENT_LOG = _native.EVENT_LOG, None
        record["launches"] = {fn.__name__: fn.launches for fn in counted}
        record["path_ms"] = {name: sum(a.elapsed_time(b) for a, b in ev)
                             for name, ev in log.items()}


def need(what, record, kernels) -> None:
    for fn in kernels:
        if record["launches"][fn.__name__] <= 0:
            fail(f"{what}: kernel {fn.__name__} was never launched")


def add_records(total, record) -> None:
    """Sum one run's launches and CUDA-event times into `total`."""
    for key in ("launches", "path_ms"):
        into = total.setdefault(key, {})
        for name, value in record[key].items():
            into[name] = into.get(name, 0) + value


def write_csr(path, graph) -> None:
    """The C program's binary CSR file."""
    with open(path, "wb") as f:
        np.asarray([graph.n, graph.m], dtype=np.int64).tofile(f)
        np.asarray(graph.xadj, dtype=np.int64).tofile(f)
        np.asarray(graph.adjncy, dtype=np.int32).tofile(f)
        np.asarray(graph.edge_weight_array(), dtype=np.int32).tofile(f)


def subprocess_env(platform=None) -> dict:
    """The environment of a CLI or C ABI subprocess: the checkout on
    PYTHONPATH (the C ABI's embedded interpreter imports the package from
    there), KAMINPAR_TPU_PLATFORM as given (unset: the card)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env.pop("KAMINPAR_TPU_PLATFORM", None)
    if platform is not None:
        env["KAMINPAR_TPU_PLATFORM"] = platform
    return env


def run_process(what, cmd, env=None, timeout=600):
    """Run one subprocess to its end; fails unless it exits 0.  Returns
    (stdout, stderr, wall seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                         env=env or subprocess_env(), timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"{what}: exit {res.returncode}: {res.stderr[-1500:]}")
    return res.stdout, res.stderr, wall


def run_c_program(what, program, csr_path, k, thread, env=None):
    """The C program's (cut, partition, wall seconds)."""
    cmd = [program, csr_path, str(k)] + (["thread"] if thread else [])
    out, _, wall = run_process(what, cmd, env)
    lines = out.split()
    if not lines or not lines[0].startswith("cut="):
        fail(f"{what}: no cut line in {out[:200]!r}")
    return int(lines[0][4:]), np.asarray(lines[1:], dtype=np.int32), wall


def build_c_abi(tmp) -> dict:
    """Build libckaminpar_tpu_torch.so and compile, against it, the smoke's
    C program and examples/c_api.c unchanged.  Returns their paths and the
    build seconds."""
    from kaminpar_tpu_torch.native.build_capi import build

    t0 = time.perf_counter()
    lib = build()
    build_s = time.perf_counter() - t0
    lib_dir = os.path.dirname(lib)
    link = [f"-I{os.path.join(REPO, 'include')}", f"-L{lib_dir}",
            "-lckaminpar_tpu_torch", f"-Wl,-rpath,{lib_dir}"]
    program_c = os.path.join(tmp, "partition_csr.c")
    with open(program_c, "w") as f:
        f.write(C_PROGRAM)
    paths = {"lib": lib, "program": os.path.join(tmp, "partition_csr"),
             "example": os.path.join(tmp, "c_api")}
    t0 = time.perf_counter()
    for src, exe, extra in ((program_c, paths["program"], ["-pthread"]),
                            (os.path.join(REPO, "examples", "c_api.c"),
                             paths["example"], [])):
        res = subprocess.run(["gcc", src, "-o", exe, *extra, *link],
                             capture_output=True, text=True)
        if res.returncode != 0:
            fail(f"gcc {os.path.basename(src)} against {lib}: "
                 f"{res.stderr[-800:]}")
    print(json.dumps({"c_abi_build": lib, "build_s": build_s,
                      "gcc_s": time.perf_counter() - t0}), flush=True)
    return paths


def check_dynamic_parity(g_small, small_default, kp, tmp, card="cuda"):
    """Phase 11a at n = 2^14, k=8, on the CPU and on the card (`card`),
    each pair bitwise equal: a three-step chain (1% churn, one vertex add
    at step 3) through run_chain with replicas 1 and 2; a step that
    inserts 10% more edges, half of them between uniformly drawn
    endpoints, which must go cold or escalate; the CLI
    (`python -m kaminpar_tpu_torch`, the card by default) against the
    CLI in this process with --device cpu; the C ABI (the smoke's C
    program, KAMINPAR_TPU_PLATFORM unset) against phase 4's CPU partition;
    and `tools components` on both devices.  Returns the C ABI build."""
    from kaminpar_tpu_torch import cli, tools
    from kaminpar_tpu_torch.dynamic import (
        GraphSession,
        random_delta_batch,
        repartition,
        run_chain,
        synth_chain,
    )
    from kaminpar_tpu_torch.graphs.host import host_partition_metrics
    from kaminpar_tpu_torch.io import write_metis, write_partition

    batches = synth_chain(g_small, steps=3, seed=41, edge_churn=0.01,
                          vertex_adds_every=3)
    for replicas in (1, 2):
        runs = {}
        for device in ("cpu", card):
            ctx = kp.context_from_preset("default")
            ctx.dynamic.replicas = replicas
            t0 = time.perf_counter()
            part, section = run_chain(graph_copy(g_small), batches, ctx,
                                      k=8, epsilon=0.03, seed=1,
                                      device=device)
            runs[device] = (part, section)
            print(json.dumps({
                "small_chain": f"replicas {replicas}", "device": device,
                "modes": [d["mode"] for d in section["decisions"]],
                "cuts": section["cut_trajectory"],
                "chain": section["sessions"][0]["chain"],
                "wall_s": round(time.perf_counter() - t0, 3)}), flush=True)
        (pc, sc), (pd, sd) = runs["cpu"], runs[card]
        if not np.array_equal(pc, pd) or sc["sessions"] != sd["sessions"]:
            fail(f"n=2^14 chain, replicas {replicas}: CPU and card differ")
        if [d["mode"] for d in sd["decisions"]] != [
                d["mode"] for d in sc["decisions"]]:
            fail(f"n=2^14 chain, replicas {replicas}: decisions differ")

    cut0 = int(host_partition_metrics(g_small, small_default, 8)["cut"])
    outs = {}
    for device in ("cpu", card):
        s = GraphSession("uniform", graph_copy(g_small), k=8)
        s.commit_partition(small_default, cut0)
        s.apply(random_delta_batch(s.graph, seed=43, edge_churn=0.1,
                                   insert_frac=1.0, uniform_frac=0.5))
        outs[device] = out = repartition(s, kp.context_from_preset("default"),
                                         k=8, epsilon=0.03, seed=1,
                                         device=device)
        print(json.dumps({"small_uniform_step": device, "mode": out.mode,
                          "escalated": out.escalated, "drift": out.drift,
                          "cut_before": cut0, "cut": out.cut}), flush=True)
    if not np.array_equal(outs["cpu"].partition, outs[card].partition):
        fail("n=2^14 uniform step: CPU and card partitions differ")
    if not (outs[card].mode == "cold" or outs[card].escalated):
        fail("n=2^14 uniform step: neither cold nor escalated")

    cli_out = os.path.join(tmp, "small.cli.part")
    _, _, wall = run_process(
        "CLI n=2^14", [sys.executable, "-m", "kaminpar_tpu_torch", SMALL_SPEC,
                       "-k", "8", "-e", "0.03", "-s", "1", "-q",
                       "-o", cli_out])
    cpu_out = os.path.join(tmp, "small.cpu.part")
    if cli.main([SMALL_SPEC, "-k", "8", "-e", "0.03", "-s", "1", "-q",
                 "--device", "cpu", "-o", cpu_out]) != 0:
        fail("CLI n=2^14 on the CPU: non-zero exit")
    ref = os.path.join(tmp, "small.phase4.part")
    write_partition(ref, small_default)
    if not (open(cli_out, "rb").read() == open(cpu_out, "rb").read()
            == open(ref, "rb").read()):
        fail("CLI n=2^14: the card's, the CPU's and phase 4's partition "
             "files differ")
    print(json.dumps({"small_cli": "bitwise-equal", "wall_s": wall}),
          flush=True)

    c_abi = build_c_abi(tmp)
    csr = os.path.join(tmp, "small.csr")
    write_csr(csr, g_small)
    cut, part, wall = run_c_program("C ABI n=2^14", c_abi["program"], csr, 8,
                                   thread=False)
    if not np.array_equal(part, small_default) or cut != cut0:
        fail("C ABI n=2^14: not phase 4's partition")
    print(json.dumps({"small_c_abi": "bitwise-equal", "cut": cut,
                      "wall_s": wall}), flush=True)

    metis = os.path.join(tmp, "small.metis")
    write_metis(g_small, metis)
    comps = {}
    for device in ("cpu", card):
        comps[device] = os.path.join(tmp, f"small.components.{device}")
        if tools.main(["components", metis, "--device", device, "-o",
                       comps[device]]) != 0:
            fail(f"tools components on {device}: non-zero exit")
    if open(comps["cpu"], "rb").read() != open(comps[card], "rb").read():
        fail("tools components: CPU and card labels differ")
    print(json.dumps({"small_components": "bitwise-equal",
                      "at_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)
    return c_abi


def run_dynamic_paths(graphs, main_parts, kp, counted, path_kernels, tmp,
                      c_abi, torch, card="cuda") -> dict:
    """Phases 11b, 11d and 11e at full width, k=16, eps=0.03, seed=1: the
    bench's medium chain (warm steps and cold twins, then replicas 2),
    each step held to the JAX package's pins (the large chain, 11c, left
    the smoke to make room for phase 15); the CLI on the
    card (phase 5's medium partition, and `--delta-batch` giving the JAX
    CLI's final partition), with its subprocess walls; the C ABI (the
    smoke's C program from a second thread, and examples/c_api.c).  Returns
    the runs' (launches, path_ms) for the kernels line."""
    from kaminpar_tpu_torch import cli
    from kaminpar_tpu_torch.dynamic import (
        GraphSession,
        repartition,
        synth_chain,
    )
    from kaminpar_tpu_torch.graphs.host import host_partition_metrics

    k1_k2 = path_kernels[:2]
    results = {}

    def register(cell):
        g = graphs[cell][0]
        part = main_parts[cell]
        pin(f"{cell} register partition", part_digest(part),
            DYNAMIC_REGISTER[cell][0])
        s = GraphSession("bench", graph_copy(g), k=K_MAIN)
        s.commit_partition(part, int(host_partition_metrics(
            g, part, K_MAIN)["cut"]))
        pin(f"{cell} register chain", s.chain[:12], DYNAMIC_REGISTER[cell][1])
        return s

    def warm_step(cell, s, batch, step, ctx, record):
        t0 = time.perf_counter()
        info = s.apply(batch)
        apply_s = time.perf_counter() - t0
        if not info["in_place"]:
            fail(f"{cell} step {step}: the apply rebuilt")
        with counting(counted, torch, record):
            t0 = time.perf_counter()
            out = repartition(s, ctx, k=K_MAIN, epsilon=0.03, seed=1,
                              device=card)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return info, out, apply_s, wall

    # -- 11b. the medium chain: warm steps and cold twins
    t0 = time.perf_counter()
    batches = synth_chain(graphs["medium"][0], steps=4, seed=41,
                          edge_churn=0.01)
    synth_s = time.perf_counter() - t0
    s = register("medium")
    ctx = kp.context_from_preset("default")
    warm_total, cold_total, rows = {}, {}, []
    for step, batch in enumerate(batches):
        drift, cut, digest, chain, twin_cut = EXPECTED_DYNAMIC["medium"][step]
        warm = {}
        info, out, apply_s, wall = warm_step("medium", s, batch, step, ctx,
                                             warm)
        pin(f"medium step {step} mode", out.mode, "warm")
        pin(f"medium step {step} drift", round(out.drift, 6), drift)
        pin(f"medium step {step} cut", out.cut, cut)
        pin(f"medium step {step} partition", part_digest(out.partition),
            digest)
        pin(f"medium step {step} chain", s.chain[:12], chain)
        need(f"medium warm step {step}", warm, k1_k2)
        cold = {}
        with counting(counted, torch, cold):
            t0 = time.perf_counter()
            twin = kp.KaMinPar("default", device=card).set_graph(
                s.graph).compute_partition(k=K_MAIN, epsilon=0.03, seed=1)
            torch.cuda.synchronize()
            cold_wall = time.perf_counter() - t0
        twin_m = host_partition_metrics(s.graph, twin, K_MAIN)
        pin(f"medium step {step} cold twin cut", int(twin_m["cut"]),
            twin_cut)
        need(f"medium cold twin {step}", cold, path_kernels)
        add_records(warm_total, warm)
        add_records(cold_total, cold)
        rows.append({"step": step, "m": info["m"], "drift": out.drift,
                     "warm_cut": out.cut, "cold_cut": int(twin_m["cut"]),
                     "apply_s": apply_s, "warm_wall_s": wall,
                     "cold_wall_s": cold_wall, "warm": warm, "cold": cold})
        print(json.dumps({"dynamic_medium_step": rows[-1], "card": CARD}),
              flush=True)
    warm_mean = statistics.mean(r["warm_wall_s"] for r in rows)
    cold_mean = statistics.mean(r["cold_wall_s"] for r in rows)
    print(json.dumps({
        "dynamic_medium": "pins held", "synth_s": synth_s,
        "warm_wall_s_mean": warm_mean, "cold_wall_s_mean": cold_mean,
        "warm_speedup": cold_mean / warm_mean,
        "max_cut_gap": max((r["warm_cut"] - r["cold_cut"]) / r["cold_cut"]
                           for r in rows),
        "in_place": s.in_place, "rebuilds": s.rebuilds,
        "at_s": round(time.perf_counter() - T_START, 1), "card": CARD}),
        flush=True)
    results["medium/dynamic warm steps (4)"] = (
        warm_total["launches"], warm_total["path_ms"])
    results["medium/dynamic cold twins (4)"] = (
        cold_total["launches"], cold_total["path_ms"])

    # ... then the replica race
    s = register("medium")
    ctx = kp.context_from_preset("default")
    ctx.dynamic.replicas = 2
    for step, batch in enumerate(batches):
        drift, cuts, cut, digest, chain = EXPECTED_DYNAMIC_REPLICAS[step]
        record = {}
        _, out, _, wall = warm_step("medium replicas", s, batch, step, ctx,
                                    record)
        pin(f"medium replicas step {step} mode", out.mode, "replica")
        pin(f"medium replicas step {step} drift", round(out.drift, 6), drift)
        pin(f"medium replicas step {step} cuts", out.replica_cuts, cuts)
        pin(f"medium replicas step {step} cut", out.cut, cut)
        pin(f"medium replicas step {step} partition",
            part_digest(out.partition), digest)
        pin(f"medium replicas step {step} chain", s.chain[:12], chain)
        need(f"medium replicas step {step}", record, path_kernels)
        print(json.dumps({"dynamic_medium_replicas_step": step,
                          "cuts": out.replica_cuts, "kept": out.cut,
                          "wall_s": wall, **record, "card": CARD}),
              flush=True)

    # -- 11d. the CLI on the card
    medium_ref = os.path.join(tmp, "medium.phase5.part")
    from kaminpar_tpu_torch.io import write_partition

    write_partition(medium_ref, main_parts["medium"])
    cli_part = os.path.join(tmp, "medium.cli.part")
    out, err, wall = run_process(
        "CLI medium", [sys.executable, "-m", "kaminpar_tpu_torch",
                       MEDIUM_SPEC, "-k", "16", "-e", "0.03", "-s", "1",
                       "-o", cli_part])
    if open(cli_part, "rb").read() != open(medium_ref, "rb").read():
        fail("CLI medium: not phase 5's partition")
    result = [ln for ln in err.splitlines() if "RESULT cut=" in ln]
    if not result:
        fail("CLI medium: no RESULT line")
    pin("CLI medium RESULT cut",
        int(result[0].split("RESULT cut=")[1].split()[0]),
        EXPECTED_CUTS["medium"])
    times = [ln for ln in out.splitlines() if ln.startswith("TIME ")]
    io_s, part_s = (float(w.split("=")[1].rstrip("s"))
                    for w in times[0].split()[1:3])
    _, _, start_s = run_process("interpreter start", [
        sys.executable, "-c", "import kaminpar_tpu_torch.cli"])
    load_out, _, _ = run_process("kernel loading", [
        sys.executable, "-c",
        "import json, time, torch\n"
        "from kaminpar_tpu_torch import _native\n"
        "t0 = time.perf_counter(); torch.cuda.init()\n"
        "torch.zeros(1, device='cuda'); t1 = time.perf_counter()\n"
        "[_native.library(s) for s in _native.SOURCES]\n"
        "print(json.dumps([t1 - t0, time.perf_counter() - t1]))"])
    cuda_init_s, load_s = json.loads(load_out)
    print(json.dumps({
        "cli_medium": "phase 5's partition", "result": result[0].strip(),
        "process_wall_s": wall, "interpreter_start_and_imports_s": start_s,
        "cuda_context_s": cuda_init_s, "kernel_loading_s": load_s,
        "io_s": io_s, "partitioning_s": part_s, "card": CARD}), flush=True)

    deltas = os.path.join(tmp, "medium.deltas.json")
    with open(deltas, "w") as f:
        json.dump([b.to_dict() for b in batches], f)
    chain_part = os.path.join(tmp, "medium.chain.part")
    out, _, wall = run_process(
        "CLI --delta-batch", [sys.executable, "-m", "kaminpar_tpu_torch",
                              MEDIUM_SPEC, "-k", "16", "-e", "0.03", "-s",
                              "1", "--delta-batch", deltas, "-o",
                              chain_part])
    cuts = [int(w.split("=")[1]) for ln in out.splitlines()
            if ln.startswith("DYNAMIC step=") for w in ln.split()
            if w.startswith("cut=")]
    pin("CLI --delta-batch cuts", cuts, EXPECTED_CLI_CHAIN[0])
    pin("CLI --delta-batch partition", part_digest(
        np.loadtxt(chain_part, dtype=np.int32)), EXPECTED_CLI_CHAIN[1])
    print(json.dumps({"cli_delta_batch": "the JAX CLI's partition",
                      "cuts": cuts, "process_wall_s": wall,
                      "chain_line": [ln for ln in out.splitlines()
                                     if ln.startswith("DYNAMIC-CHAIN")],
                      "card": CARD}), flush=True)

    # the CLI's main in this process, for the launch counts
    record = {}
    inproc = os.path.join(tmp, "medium.inproc.part")
    with counting(counted, torch, record):
        rc = cli.main([MEDIUM_SPEC, "-k", "16", "-e", "0.03", "-s", "1",
                       "-q", "--device", card, "-o", inproc])
    if rc != 0 or open(inproc, "rb").read() != open(medium_ref, "rb").read():
        fail("CLI medium in this process: not phase 5's partition")
    need("CLI medium", record, path_kernels)
    results["medium/CLI"] = (record["launches"], record["path_ms"])

    # -- 11e. the C ABI on the card
    out, _, wall = run_process("examples/c_api.c", [c_abi["example"]])
    if not out.startswith("cut="):
        fail(f"examples/c_api.c: {out[:200]!r}")
    csr = os.path.join(tmp, "medium.csr")
    write_csr(csr, graphs["medium"][0])
    cut, part, c_wall = run_c_program("C ABI medium", c_abi["program"], csr,
                                     K_MAIN, thread=True)
    pin("C ABI medium cut", cut, EXPECTED_CUTS["medium"])
    if not np.array_equal(part, main_parts["medium"]):
        fail("C ABI medium: not phase 5's partition")
    print(json.dumps({"c_abi_medium": "phase 5's partition",
                      "example": out.strip(), "second_thread": True,
                      "process_wall_s": c_wall,
                      "at_s": round(time.perf_counter() - T_START, 1),
                      "card": CARD}), flush=True)
    results.update(c_abi_in_process(c_abi["lib"], graphs["medium"][0],
                                    main_parts["medium"], counted,
                                    path_kernels, torch))
    return results


def c_abi_in_process(lib, graph, expected, counted, path_kernels,
                     torch) -> dict:
    """The C ABI's kmp_compute_partition called in this process through
    ctypes (the library finds this interpreter running), for the launch
    counts.  Only where libpython is a shared library: with a static
    interpreter the library would start a second runtime."""
    import ctypes
    import sysconfig

    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        print(json.dumps({"c_abi_launches": "not measured (static "
                          "libpython)"}), flush=True)
        return {}
    c = ctypes.CDLL(lib)
    c.kmp_create.restype = ctypes.c_void_p
    c.kmp_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    c.kmp_free.argtypes = [ctypes.c_void_p]
    c.kmp_last_error.restype = ctypes.c_char_p
    c.kmp_last_error.argtypes = [ctypes.c_void_p]
    c.kmp_compute_partition.restype = ctypes.c_int64
    ptr = ctypes.c_void_p
    c.kmp_compute_partition.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ptr, ptr, ptr, ptr, ctypes.c_int32,
        ctypes.c_double, ptr]
    xadj = np.ascontiguousarray(graph.xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(graph.adjncy, dtype=np.int32)
    adjwgt = np.ascontiguousarray(graph.edge_weight_array(), dtype=np.int32)
    out = np.full(graph.n, -1, dtype=np.int32)
    p = c.kmp_create(b"default", 1)
    record = {}
    with counting(counted, torch, record):
        cut = c.kmp_compute_partition(
            p, graph.n, xadj.ctypes.data, adjncy.ctypes.data, None,
            adjwgt.ctypes.data, K_MAIN, 0.03, out.ctypes.data)
    err = c.kmp_last_error(p)
    c.kmp_free(p)
    if cut < 0:
        fail(f"C ABI in this process: {err!r}")
    pin("C ABI in this process, cut", cut, EXPECTED_CUTS["medium"])
    if not np.array_equal(out, expected):
        fail("C ABI in this process: not phase 5's partition")
    need("C ABI medium", record, path_kernels)
    print(json.dumps({"c_abi_in_process": "phase 5's partition",
                      **record, "card": CARD}), flush=True)
    return {"medium/C ABI": (record["launches"], record["path_ms"])}


# ---------------------------------------------------------------------------
# phase 12: the distributed partitioner
# ---------------------------------------------------------------------------

# the dist variants of phases 12a-b: (preset, lp_rating, clustering) of
# the DistContext; local-lp with the scatter engine is the one that passes
# label_range= to the standalone K3
DIST_VARIANTS = {
    "default": ("default", None, None),
    "scatter": ("default", "scatter", None),
    "local-lp": ("default", "scatter", "local-lp"),
    "strong": ("strong", None, None),
    "colored-lp": ("colored-lp", None, None),
    "cluster-balancer": ("cluster-balancer", None, None),
    "hem-lp": ("default", None, "global-hem-lp"),
}


def dist_solver(kp, D, variant, device):
    """dKaMinPar on D shards of `device`, with the variant's preset,
    rating engine and clusterer."""
    from kaminpar_tpu_torch.parallel.dist_context import (
        DistClusteringAlgorithm,
    )

    preset, lp_rating, clustering = DIST_VARIANTS[variant]
    solver = kp.parallel.dKaMinPar(preset, n_devices=D, device=device)
    if lp_rating is not None:
        solver.ctx.lp_rating = lp_rating
    if clustering is not None:
        solver.ctx.clustering = DistClusteringAlgorithm(clustering)
    return solver


def check_dist_kernels(graph, kp, gather, rating, dev, torch) -> dict:
    """Phase 3 at the dist path's shapes: shard 0 (the heaviest) of the
    medium graph on 8 shards in the first LP round (every node its own
    cluster): the standalone K3 on the shard's scatter slot table (rows
    n_loc, labels global) with label_range= (local-lp's) and with
    communities=, and K2 over the shard's CSR spans with the
    ghost-extended label table, each bitwise against its twin on the same
    CUDA tensors, with rows whose winner the mask changes, and timed
    beside its bound.  Returns the fields each kernel's entry gets."""
    mesh = kp.parallel.make_mesh(DIST_SHARDS, device=dev)
    dg = kp.parallel.dist_graph_from_host(graph, mesh)
    sh = dg.shard(0)
    n_loc, g_loc, C = dg.n_loc, dg.g_loc, dg.n_pad
    ids = torch.arange(C, dtype=torch.int32, device=dev)
    lab_tab = torch.cat([ids[:n_loc], ids[sh.ghost_gid.long()]])
    dstloc = sh.dst_local.clamp(0, n_loc + g_loc - 1)
    seg = sh.src - sh.offset
    nb = gather.gather_i32(lab_tab, dstloc)
    from kaminpar_tpu_torch.ops.lp import LPConfig

    num_slots, salt = LPConfig().num_slots, 12345
    sl, sw, _ = rating.scatter_slot_ratings(
        seg.clamp(0, n_loc - 1), nb, sh.edge_w, n_loc, num_slots, salt,
        valid=(seg >= 0) & (seg < n_loc), label_space=C)
    cap = torch.full((C,), 64, dtype=torch.int32, device=dev)
    args = (sl, sw, lab_tab[:n_loc].contiguous(), dg.node_w, sh.node_w,
            cap, salt)
    comm = (torch.arange(n_loc, dtype=torch.int32, device=dev) * 7) % 16
    ranged = {"label_range": (sh.offset, sh.offset + n_loc)}
    cases = {"label_range": ranged, "communities": {"communities": comm},
             "both": dict(ranged, communities=comm)}
    plain = rating.best_from_slots(*args)[0]
    changed, err = {}, 0
    for what, kw in cases.items():
        out = rating.best_from_slots(*args, **kw)
        ref = rating.best_from_slots_twin(*args, **kw)
        torch.cuda.synchronize()
        for x, y in zip(out, ref):
            if not torch.equal(x, y):
                fail(f"K3 with {what} disagrees with its twin at the dist "
                     "shard shapes")
            err = max(err, max_abs_err(x, y))
        changed[what] = int((out[0] != plain).sum())
        if changed[what] == 0:
            fail(f"K3 {what} check is blind: the mask changed no winner")
    rows, S = sl.shape
    b, by, _ = cost_bound(rating.best_from_slots_cost(sl))
    ms, _, ms_by = device_ms(
        lambda: rating.best_from_slots(*args, **ranged), torch)
    k3 = {"dist": {
        "shape": {"graph": "medium", "shards": DIST_SHARDS, "shard": 0,
                  "rows": rows, "slots": S, "labels": C},
        "masked_rows": changed, "max_abs_err": err,
        "ms": ms, "ms_by": ms_by,
        "unmasked_ms": device_ms(lambda: rating.best_from_slots(*args),
                                 torch)[0],
        "plain_ms": time_ms(
            lambda: rating.best_from_slots_twin(*args, **ranged), torch),
        "bound_ms": b, "bound_by": by,
    }}
    print_k3_vs_parent("dist shard, label_range", ms)
    # K2: a 16-block table over the shard's spans, labels owned + ghosts
    part_tab = ((lab_tab * 5) % K_MAIN).to(torch.int32)
    m_shard = int(sh.row_end[-1])
    args2 = (sh.row_start, sh.row_end, dstloc, sh.edge_w, part_tab, n_loc,
             K_MAIN)
    out = gather.dense_block_ratings(*args2)
    ref = gather.dense_block_ratings_twin(*args2)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fail("K2 with a ghost-extended label table disagrees with its twin")
    b2, by2, _ = cost_bound(gather.dense_block_ratings_cost(*args2))
    ms2, _, ms2_by = device_ms(lambda: gather.dense_block_ratings(*args2),
                               torch)
    k2 = {"dist": {
        "shape": {"graph": "medium", "shards": DIST_SHARDS, "shard": 0,
                  "rows": n_loc, "labels": n_loc + g_loc, "edges": m_shard,
                  "k": K_MAIN},
        "max_abs_err": max_abs_err(out, ref),
        "ms": ms2, "ms_by": ms2_by,
        "plain_ms": time_ms(
            lambda: gather.dense_block_ratings_twin(*args2), torch),
        "bound_ms": b2, "bound_by": by2,
    }}
    print(json.dumps({"dist_kernel_checks": "ok", "k3_masked_rows": changed,
                      "shard_edges": m_shard, "n_loc": n_loc,
                      "g_loc": g_loc}), flush=True)
    return {"best_from_slots": k3, "dense_block_ratings": k2}


def check_dist_parity(g_small, kp, torch, tmp) -> None:
    """Phase 12a: the parity graph at k=8 on the CPU and on the card, each
    pair bitwise equal: `default` at D = 1, 2, 8 and on a (2, 4) grid, the
    scatter engine and local-lp (D = 8), the forced sharded contraction,
    and on 2 shards `strong`, `cluster-balancer` and HEM + LP clustering
    at n = 2^12 and `colored-lp` on a 64x64 grid; then on the card a hard
    stop at dist-uncoarsen:0 (D = 2, where the
    input is not replicated) and its resume, giving the card's D = 2
    partition, and the dcli at D = 8, giving the card's D = 8 partition."""
    from kaminpar_tpu_torch import dcli
    from kaminpar_tpu_torch.io.metis import write_metis
    from kaminpar_tpu_torch.parallel import dist_partitioner as tdp
    from kaminpar_tpu_torch.resilience.checkpoint import SimulatedPreemption

    real_contract = tdp.dist_contract_clustering
    real_limit = tdp.MAX_FUSED_EDGE_SLOTS
    sharded = []

    def spy(*a, **kw):
        sharded.append(1)
        return real_contract(*a, **kw)

    cases = [("default", 1), ("default", 2), ("default", 8),
             ("default", (2, 4)), ("scatter", 8), ("local-lp", 8),
             ("sharded-contraction", 8)]
    card = {}
    for variant, D in cases:
        parts = {}
        for device in ("cpu", "cuda"):
            forced = variant == "sharded-contraction"
            solver = dist_solver(kp, D, "default" if forced else variant,
                                 device)
            t0 = time.perf_counter()
            if forced:
                tdp.MAX_FUSED_EDGE_SLOTS = 0
                tdp.dist_contract_clustering = spy
            try:
                parts[device] = solver.set_graph(g_small).compute_partition(
                    k=8, epsilon=0.03, seed=1)
            finally:
                tdp.MAX_FUSED_EDGE_SLOTS = real_limit
                tdp.dist_contract_clustering = real_contract
            print(json.dumps({
                "dist_small": variant, "shards": D, "device": device,
                "replicated": solver._replication_info is not None,
                "wall_s": round(time.perf_counter() - t0, 3)}), flush=True)
        if not np.array_equal(parts["cpu"], parts["cuda"]):
            fail(f"dist n=2^14 {variant} D={D}: CPU and CUDA partitions "
                 f"differ in {int((parts['cpu'] != parts['cuda']).sum())} "
                 "nodes")
        card[(variant, D)] = parts["cuda"]
    if not sharded:
        fail("dist n=2^14: the forced sharded contraction never ran")
    # the other refiners and clusterers (Jet, colored LP, the cluster
    # balancer, HEM + LP) at n = 2^12 on 2 shards; colored LP on a 64x64
    # grid, whose few colors keep its supersteps (colors x iterations)
    # short
    g_tiny = kp.make_rmat(1 << 12, 32_000, seed=3)
    g_grid = kp.graphs.factories.make_grid_graph(64, 64)
    for variant in ("strong", "colored-lp", "cluster-balancer", "hem-lp"):
        parts = {}
        graph = g_grid if variant == "colored-lp" else g_tiny
        for device in ("cpu", "cuda"):
            t0 = time.perf_counter()
            parts[device] = dist_solver(kp, 2, variant, device).set_graph(
                graph).compute_partition(k=8, epsilon=0.03, seed=1)
            print(json.dumps({
                "dist_tiny": variant, "shards": 2, "device": device,
                "wall_s": round(time.perf_counter() - t0, 3)}), flush=True)
        if not np.array_equal(parts["cpu"], parts["cuda"]):
            fail(f"dist n=2^12 {variant}: CPU and CUDA partitions differ")
    # kill and resume on the card
    ckpt = os.path.join(tmp, "dist-ckpt")
    solver = dist_solver(kp, 2, "default", "cuda")
    solver.ctx.shm.resilience.checkpoint_dir = ckpt
    try:
        with env_scope({"KAMINPAR_TPU_STOP_AT": "dist-uncoarsen:0!"}):
            solver.set_graph(g_small).compute_partition(k=8, epsilon=0.03,
                                                        seed=1)
        fail("dist: the hard stop at dist-uncoarsen:0 never fired")
    except SimulatedPreemption:
        pass
    RESILIENCE_EVENTS.clear()
    solver = dist_solver(kp, 2, "default", "cuda")
    solver.ctx.shm.resilience.checkpoint_dir = ckpt
    solver.ctx.shm.resilience.resume = True
    resumed = solver.set_graph(g_small).compute_partition(k=8, epsilon=0.03,
                                                          seed=1)
    if not any(n == "resume" for n, _ in RESILIENCE_EVENTS):
        fail("dist: the resumed run restored nothing")
    if not np.array_equal(resumed, card[("default", 2)]):
        fail("dist: the resumed partition is not the uninterrupted one")
    ref = card[("default", 8)]
    # the dcli on the card
    path, out = os.path.join(tmp, "small.metis"), os.path.join(tmp, "p.txt")
    write_metis(g_small, path)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    try:
        rc = dcli.main([path, "-k", "8", "-n", "8", "-s", "1", "-q",
                        "-o", out])
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
    if rc != 0 or not np.array_equal(np.loadtxt(out, dtype=np.int64), ref):
        fail("dist: the dcli's partition is not the facade's")
    print(json.dumps({"dist_small_parity": "bitwise-equal",
                      "cases": [f"{v}/{d}" for v, d in cases]
                      + ["strong", "colored-lp", "cluster-balancer",
                         "hem-lp"],
                      "resume": "dist-uncoarsen:0 (D=2)", "dcli": "D=8"}),
          flush=True)


def run_dist_paths(graphs, kp, counted, dev, torch) -> dict:
    """Phase 12b: dKaMinPar on 8 shards of the card at full width, k=16,
    one run per cell of EXPECTED_DIST_CUTS, each counted from zero: the
    cut pinned to the JAX package's, the partition in range and within
    the caps, K1 and K2 launched in every cell and the standalone K3 in
    the scatter cells; prints the walls per phase, the levels' per-shard
    edge counts and the peak allocation."""
    from kaminpar_tpu_torch.ops import gather, rating

    runs = {}
    for (cell, variant), expected in EXPECTED_DIST_CUTS.items():
        graph = graphs[cell][0]
        record = {}
        RESILIENCE_EVENTS.clear()
        solver = dist_solver(kp, DIST_SHARDS, variant, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with counting(counted, torch, record):
            t0 = time.perf_counter()
            part = solver.set_graph(graph).compute_partition(
                k=K_MAIN, epsilon=0.03, seed=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if loud_events():
            fail(f"dist {cell}/{variant}: events {loud_events()[:3]}")
        if part.shape != (graph.n,) or part.min() < 0 or (
                part.max() >= K_MAIN):
            fail(f"dist {cell}/{variant}: partition out of range")
        bw = np.bincount(part, weights=graph.node_weight_array(),
                         minlength=K_MAIN).astype(np.int64)
        caps = np.asarray(solver.ctx.partition.unrelaxed_max_block_weights)
        if (bw > caps).any():
            fail(f"dist {cell}/{variant}: block weights over the caps")
        src = graph.edge_sources()
        cut = int(graph.edge_weight_array()[
            part[src] != part[graph.adjncy]].sum() // 2)
        pin(f"dist {cell}/{variant} cut", cut, expected)
        need(f"dist {cell}/{variant}", record,
             (gather.gather_i32, gather.dense_block_ratings)
             + ((rating.best_from_slots,) if variant != "default" else ()))
        perfect = -(-graph.total_node_weight // K_MAIN)
        print(json.dumps({
            "dist_path": f"{cell}/{variant}", "shards": DIST_SHARDS,
            "pinned": expected, "cut": cut,
            "imbalance": float(bw.max() / perfect - 1.0),
            "wall_s": wall, "phase_s": solver.last_timings,
            "replication": solver._replication_info,
            "levels": [(lv["n"], lv["m"]) for lv in solver.last_levels],
            "shard_edges": solver.last_levels[0]["shard_edges"],
            "peak_bytes": peak, "launches": record["launches"],
            "path_ms": record["path_ms"],
            "at_s": round(time.perf_counter() - T_START, 1), "card": CARD,
        }), flush=True)
        runs[f"dist/{cell}/{variant}"] = (record["launches"],
                                          record["path_ms"])
    return runs


# ---------------------------------------------------------------------------
# phase 13: partitioning as a service

# the hard ceiling of 13a's injected worker hang (seconds)
SERVE_HANG_S = 5.0
PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.e+-]+$')


def serving_record(rec) -> dict:
    """A request's record without its partition, for the log."""
    return {k: v for k, v in rec.to_dict().items() if k != "phases"}


def check_serving_parity(g_small, small_default, kp, torch):
    """13a: one batch through PartitionService on the CPU and on the card
    in this process (verdicts and partitions bitwise equal, the graph
    object's partition phase 4's), then the same requests in a worker
    that a process-isolated service spawns on the card, an injected hang
    and an injected crash.  Returns that service, whose queue 13b goes on
    serving."""
    from kaminpar_tpu_torch.serving import (
        PartitionRequest,
        PartitionService,
        ServiceConfig,
    )

    def batch(prefix=""):
        return [PartitionRequest(g_small, k=8, seed=1,
                                 request_id=prefix + "small-graph"),
                PartitionRequest(SMALL_SPEC, k=8, seed=2,
                                 request_id=prefix + "small-spec")]

    kp.resilience.reset()
    recs = {}
    for device in ("cpu", "cuda"):
        svc = PartitionService("default", ServiceConfig(keep_partitions=True),
                               device=device)
        t0 = time.perf_counter()
        recs[device] = svc.serve(batch())
        svc.close()
        print(json.dumps({"serving_small": device,
                          "wall_s": round(time.perf_counter() - t0, 3),
                          "records": [serving_record(r)
                                      for r in recs[device]]}), flush=True)
    for c, g in zip(recs["cpu"], recs["cuda"]):
        if c.verdict != "served" or (c.verdict, c.reason, c.cut) != (
                g.verdict, g.reason, g.cut):
            fail(f"serving n=2^14 {c.request_id}: CPU {serving_record(c)}, "
                 f"card {serving_record(g)}")
        if not np.array_equal(c.partition, g.partition):
            fail(f"serving n=2^14 {c.request_id}: CPU and card partitions "
                 "differ")
    if not np.array_equal(recs["cuda"][0].partition, small_default):
        fail("serving n=2^14: not phase 4's partition")

    worker_svc = PartitionService(
        "default", ServiceConfig(isolation="process", keep_partitions=True),
        device="cuda")
    t0 = time.perf_counter()
    with env_scope({"KAMINPAR_TPU_FAULTS":
                    "worker-hang:nth=3,worker-crash:nth=4"}):
        got = worker_svc.serve(batch("worker-") + [
            PartitionRequest(SMALL_SPEC, k=8, seed=3,
                             hard_deadline_s=SERVE_HANG_S,
                             request_id="worker-hang"),
            PartitionRequest(SMALL_SPEC, k=8, seed=4,
                             request_id="worker-crash")])
    wall = time.perf_counter() - t0
    hangs = worker_svc.supervision_summary()["hangs"]
    kp.resilience.reset()
    for c, w in zip(recs["cpu"], got):
        if w.verdict != "served" or not np.array_equal(c.partition,
                                                       w.partition):
            fail(f"serving n=2^14 in the worker, {w.request_id}: "
                 f"{serving_record(w)}, not the CPU's partition")
    verdicts = [(r.verdict, r.reason) for r in got[2:]]
    if verdicts != [("failed", "worker-hang"), ("failed", "worker-crash")]:
        fail(f"serving n=2^14: the injected hang and crash gave {verdicts}")
    pool = worker_svc._pool
    print(json.dumps({
        "serving_worker_small": "CPU partitions, hang and crash contained",
        "wall_s": round(wall, 3),
        "records": [serving_record(r) for r in got],
        "workers": pool.stats, "spawn_s": list(pool.spawn_seconds),
        "worker_rss_at_spawn_bytes": list(pool.spawn_rss_bytes),
        "worker_rss_bytes": list(pool.rss_bytes),
        "hangs": hangs,
        "at_s": round(time.perf_counter() - T_START, 1), "card": CARD,
    }), flush=True)
    return worker_svc


def run_serving_paths(graphs, main_parts, main_walls, worker_svc, kp,
                      counted, path_kernels, torch, tmp) -> dict:
    """13b: the service at full width in this process (with a metrics
    file scraped mid-batch and a heartbeat), the large graph in the
    worker, and the CLI's --serve-batch in a subprocess."""
    from kaminpar_tpu_torch.resilience import supervisor
    from kaminpar_tpu_torch.serving import (
        PartitionRequest,
        PartitionService,
        ServiceConfig,
    )
    from kaminpar_tpu_torch.telemetry import metrics as metrics_mod

    runs = {}
    g_large, g_med = graphs["large"][0], graphs["medium"][0]
    prom = os.path.join(tmp, "service.prom")
    heartbeat = os.path.join(tmp, "service.heartbeat")
    with env_scope({"KAMINPAR_TPU_METRICS_CADENCE_S": "0.5"}):
        svc = PartitionService("default", ServiceConfig(
            keep_partitions=True, metrics_file=prom,
            heartbeat_file=heartbeat), device="cuda")
    hb0 = (os.stat(heartbeat).st_mtime_ns,
           supervisor.heartbeat_state()["count"])

    def serve(rid, graph, record):
        with counting(counted, torch, record):
            rec = svc.serve([PartitionRequest(graph, k=K_MAIN,
                                              epsilon=0.03, seed=1,
                                              request_id=rid)])[0]
        print(json.dumps({
            "serving": rid, "record": serving_record(rec),
            "phases_ms": rec.phases,
            "peak_device_bytes": rec.device_peak_bytes,
            "launches": record["launches"], "path_ms": record["path_ms"],
            "at_s": round(time.perf_counter() - T_START, 1), "card": CARD,
        }), flush=True)
        if rec.verdict != "served":
            fail(f"serving {rid}: {serving_record(rec)}")
        return rec

    try:
        record = {}
        large = serve("large", g_large, record)
        if large.cached or large.cut != EXPECTED_CUTS["large"] or (
                part_digest(large.partition)
                != part_digest(main_parts["large"])):
            fail(f"serving large: {serving_record(large)}, not phase 5's "
                 "partition")
        need("serving large", record, path_kernels[:2])
        runs["serving/large"] = (record["launches"], record["path_ms"])
        # a scrape mid-batch: the cadence thread (every 0.5 s) publishes
        # the first verdict
        for _ in range(40):
            with open(prom) as f:
                scrape = f.read().splitlines()
            if any(ln.startswith("kmp_requests_total") for ln in scrape):
                break
            time.sleep(0.05)
        bad = [ln for ln in scrape
               if not ln.startswith("#") and not PROM_SAMPLE.match(ln)]
        if bad or not any(ln.startswith("kmp_requests_total")
                          for ln in scrape):
            fail(f"metrics scrape mid-batch: {bad[:3] or scrape[:5]}")
        record = {}
        dup = serve("large-duplicate", g_large, record)
        if not dup.cached or any(record["launches"].values()) or (
                part_digest(dup.partition) != part_digest(large.partition)):
            fail(f"serving the duplicate: {serving_record(dup)}, launches "
                 f"{record['launches']}")
        record = {}
        med = serve("medium", g_med, record)
        if med.cut != EXPECTED_CUTS["medium"] or (
                part_digest(med.partition)
                != part_digest(main_parts["medium"])):
            fail(f"serving medium: {serving_record(med)}, not phase 5's "
                 "partition")
        need("serving medium", record, path_kernels)
        runs["serving/medium"] = (record["launches"], record["path_ms"])
        hb1 = (os.stat(heartbeat).st_mtime_ns,
               supervisor.heartbeat_state()["count"])
        if not (hb1[0] > hb0[0] and hb1[1] > hb0[1]):
            fail(f"serving: the heartbeat did not advance ({hb0} -> {hb1})")
        summary = svc.summary()
    finally:
        svc.close()
        metrics_mod.reset()
        supervisor.set_heartbeat(None)
    print(json.dumps({
        "serving_summary": summary["counts"],
        "cache": summary["cache"]["result"],
        "latency_total": summary["latency"]["phases"]["total"],
        "serve_wall_s": {"large": large.wall_s, "medium": med.wall_s},
        "direct_wall_s": main_walls,
        "metrics_lines": len(scrape), "heartbeat": [hb0, hb1],
        "card": CARD}), flush=True)

    # the medium graph in the worker (the large one until the smoke made
    # room for phase 15: its 14.6 s of npz and 8.3 s of spawn are PERF.md
    # section 5's): the queue serves on after the hang and the crash; the
    # worker's own launches, and their CUDA-event ms (EVENT_LOG set here has
    # the worker time them), come back in its reply and ride on the
    # request's record
    pool = worker_svc._pool
    spawned = pool.stats["spawned"]
    parent = {}
    t0 = time.perf_counter()
    with counting(counted, torch, parent):
        rec = worker_svc.serve([PartitionRequest(
            g_med, k=K_MAIN, epsilon=0.03, seed=1,
            request_id="worker-medium")])[0]
    wall = time.perf_counter() - t0
    launches = {fn.__name__: rec.worker_launches.get(fn.__name__, 0)
                for fn in counted}
    worker_ms = rec.worker_kernel_ms
    print(json.dumps({
        "serving_worker": "medium", "record": serving_record(rec),
        "phases_ms": rec.phases, "wall_s": round(wall, 3),
        "launches_in_worker": launches, "path_ms_in_worker": worker_ms,
        "launches_in_parent": parent["launches"],
        "spawned": pool.stats["spawned"] - spawned,
        "spawn_s": list(pool.spawn_seconds),
        "ship_s": list(pool.ship_seconds),
        "worker_rss_at_spawn_bytes": list(pool.spawn_rss_bytes),
        "worker_rss_bytes": list(pool.rss_bytes),
        "rss_limit_bytes": pool.rss_limit_bytes,
        "peak_device_bytes": rec.device_peak_bytes,
        "workers": pool.stats, "direct_wall_s": main_walls["medium"],
        "at_s": round(time.perf_counter() - T_START, 1), "card": CARD,
    }), flush=True)
    if rec.verdict != "served" or rec.cut != EXPECTED_CUTS["medium"] or (
            part_digest(rec.partition) != part_digest(main_parts["medium"])):
        fail(f"serving medium in the worker: {serving_record(rec)}, not "
             "the partition served in this process")
    need("serving medium in the worker", {"launches": launches},
         path_kernels)
    if any(parent["launches"].values()):
        fail("serving medium in the worker: the parent launched "
             f"{parent['launches']}, not the worker")
    if worker_ms is None or sorted(worker_ms) != sorted(launches) or any(
            launches[name] > 0 and not worker_ms[name] > 0
            for name in launches):
        fail(f"serving medium in the worker: its launches {launches} came "
             f"back with CUDA-event ms {worker_ms}")
    runs["serving/medium in the worker"] = (launches, worker_ms)

    # the command line's batch mode on the card, with its files
    batch = os.path.join(tmp, "batch.json")
    with open(batch, "w") as f:
        json.dump({"requests": [
            {"graph": MEDIUM_SPEC, "k": K_MAIN, "epsilon": 0.03, "seed": 1,
             "id": "medium"},
            {"graph": MEDIUM_SPEC, "k": K_MAIN, "epsilon": 0.03, "seed": 1,
             "id": "medium-again"}]}, f)
    trace, prom, heartbeat = (os.path.join(tmp, name) for name in (
        "cli.trace.json", "cli.prom", "cli.heartbeat"))
    out, _, wall = run_process("CLI --serve-batch", [
        sys.executable, "-m", "kaminpar_tpu_torch", "--serve-batch", batch,
        "--trace-out", trace, "--metrics-file", prom,
        "--heartbeat-file", heartbeat])
    served = [ln for ln in out.splitlines() if ln.startswith("SERVED ")]
    if len(served) != 2 or f"cut={EXPECTED_CUTS['medium']}" not in served[0] \
            or "cache=hit" not in served[1]:
        fail(f"CLI --serve-batch: {served}")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    spans = {(e["name"], e["args"].get("trace_id", "")[:3])
             for e in events if e.get("cat") == "request"}
    tracks = {e["args"]["name"] for e in events if e["ph"] == "M"}
    if not {"request medium", "request medium-again"} <= tracks or (
            ("compute", "tr-") not in spans):
        fail(f"CLI --trace-out: tracks {sorted(tracks)[:6]}")
    with open(prom) as f:
        names = sorted({ln.split()[2] for ln in f.read().splitlines()
                        if ln.startswith("# TYPE ")})
    if "kmp_requests_total" not in names or not os.path.exists(heartbeat):
        fail(f"CLI --metrics-file / --heartbeat-file: {names}")
    print(json.dumps({"cli_serve_batch": served, "wall_s": round(wall, 3),
                      "trace_tracks": len(tracks), "metric_names": names,
                      "at_s": round(time.perf_counter() - T_START, 1),
                      "card": CARD}), flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 14: the observatory on the card
# ---------------------------------------------------------------------------

# the large graph's level-0 device buffers (PERF.md section 4): the
# padded CSR (row_ptr, src, dst, edge_w, node_w) and its cluster map
# (4 * n_pad); the csr-upload row carries the CSR, 415,236,100 less the map
LARGE_LEVEL0_BUFFER_BYTES = 415_236_100


def progress_rows(report) -> list:
    """The report's progress series, the quality observatory's hierarchy
    ids renumbered by first appearance (they count per process)."""
    ids = {}
    rows = []
    for p in report["progress"]:
        attrs = dict(p["attrs"])
        if attrs.get("quality_hierarchy") is not None:
            attrs["quality_hierarchy"] = ids.setdefault(
                attrs["quality_hierarchy"], len(ids))
        rows.append([p["kind"], p["path"], p["iterations"], p["series"],
                     attrs])
    return rows


def integer_sections(report) -> dict:
    """What the observatory records that must not depend on the device:
    progress series, quality rows, pad-waste rows, the memory stages,
    the transfer rows."""
    return {
        "progress": progress_rows(report),
        "quality": report["quality"],
        "pad_waste": report["perf"]["pad_waste"],
        "memory_stages": [(s["stage"], s.get("level"))
                          for s in report["perf"]["memory"]["samples"]],
        "transfers": sorted(
            (r["scope"], r["direction"], r["kind"], r["count"], r["bytes"])
            for r in report["ledger"]["transfers"]["rows"]),
    }


@contextlib.contextmanager
def cost_spy(gather, rating, record):
    """Wrap the four cost functions as the wrappers call them: `record`
    gets, per (scope, kernel), the launches and the summed bytes the
    cost functions returned (device scalars summed at the end), so the
    roofline rows can be held to launches x cost."""
    from kaminpar_tpu_torch import telemetry as tel

    saved = []
    pending = []
    for mod, name in ((gather, "gather_i32_cost"),
                      (gather, "dense_block_ratings_cost"),
                      (rating, "best_from_slots_cost"),
                      (rating, "scatter_best_from_slots_cost")):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def spy(*args, _fn=fn, _name=name[:-5], **kwargs):
            cost = _fn(*args, **kwargs)
            pending.append((tel.current_scope_path() or "(outside scopes)",
                            _name, cost[0]))
            return cost

        setattr(mod, name, spy)
    try:
        yield record
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        for path, kernel, nbytes in pending:
            row = record.setdefault(path, {"launches": 0, "bytes": 0,
                                           "kernels": {}})
            row["launches"] += 1
            row["bytes"] += int(nbytes)
            row["kernels"][kernel] = row["kernels"].get(kernel, 0) + 1


def check_roofline(what, report, spied) -> dict:
    """Every scope that launched a kernel has a roofline row whose
    launches and bytes are the cost functions' per launch, summed."""
    roof = report["perf"]["roofline"]
    if set(roof) != set(spied):
        fail(f"{what}: roofline scopes {sorted(roof)} are not the "
             f"launching scopes {sorted(spied)}")
    for path, row in roof.items():
        want = spied[path]
        if (row["launches"], row["bytes"], row["kernels"]) != (
                want["launches"], want["bytes"], want["kernels"]):
            fail(f"{what}: roofline row {path} {row['launches']} launches "
                 f"{row['bytes']} B, the cost functions give "
                 f"{want['launches']} launches {want['bytes']} B")
    return {path: {k: row.get(k) for k in (
        "launches", "kernels", "bytes", "flops", "wall_s", "self_s",
        "build_s", "kernel_ms", "rate_over", "achieved_gbps", "hbm_util",
        "deficit_s")} for path, row in roof.items()}


def run_observatory(graphs, main_parts, main_walls, g_small, small_default,
                    kp, counted, path_kernels, dev, metrics,
                    device_graph_from_host, torch, tmp,
                    names=("large", "medium")) -> dict:
    """Phase 14: every observatory layer on.  14a the n = 2^14 graph on
    the CPU and the card (equal integer sections, phase 4's partition);
    14b large and medium `default` (phase 5's partitions and pins, the
    walls beside a layers-off run in this process, roofline rows held to
    the cost functions, the quality headline, the upload bytes, the
    memory samples, the build account); 14c the medium scatter cell on 8
    shards (its pin, a standalone K3 roofline row); 14d the `top` and
    `quality` renderers on 14b's report and a cold build in a fresh
    cache directory.  Returns the slice runs for the kernels line."""
    from kaminpar_tpu_torch import _native
    from kaminpar_tpu_torch import telemetry as tel
    from kaminpar_tpu_torch.ops import gather, rating
    from kaminpar_tpu_torch.telemetry import quality
    from kaminpar_tpu_torch.telemetry.report import (
        build_run_report,
        validate_report,
    )

    t_phase = time.perf_counter()
    runs = {}
    # -- 14a
    sections = {}
    for device in ("cpu", "cuda"):
        tel.enable()
        try:
            solver = kp.KaMinPar("default", device=device)
            t0 = time.perf_counter()
            part = solver.set_graph(g_small).compute_partition(
                k=8, epsilon=0.03, seed=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            report = build_run_report()
        finally:
            tel.disable()
        errors = validate_report(report)
        if errors:
            fail(f"observatory n=2^14 {device}: report {errors[:3]}")
        if not np.array_equal(part, small_default):
            fail(f"observatory n=2^14 {device}: not phase 4's partition")
        sections[device] = integer_sections(report)
        print(json.dumps({"observatory_small": device,
                          "wall_s": round(wall, 3),
                          "series": len(sections[device]["progress"])}),
              flush=True)
    for key in sections["cpu"]:
        if sections["cpu"][key] != sections["cuda"][key]:
            fail(f"observatory n=2^14: the {key} sections of the CPU and "
                 "the card differ")
    if not sections["cpu"]["progress"] or not sections["cpu"]["quality"]:
        fail("observatory n=2^14: no progress series or quality section")
    print(json.dumps({"observatory_small_parity": sorted(sections["cpu"]),
                      "result": "equal"}), flush=True)

    # -- 14b
    reports = {}
    for name in names:
        spied = {}
        tel.enable()
        record = {}
        try:
            with cost_spy(gather, rating, spied):
                with counting(counted, torch, record):
                    part, solver = run_main(
                        name, graphs[name][0], kp, counted, dev, metrics,
                        device_graph_from_host, torch, "default",
                        EXPECTED_CUTS[name], run="observatory on")
            report = build_run_report()
            headline = quality.headline()
        finally:
            tel.disable()
        if not np.array_equal(part, main_parts[name]):
            fail(f"observatory {name}: not phase 5's partition")
        wall_on = solver.smoke_wall
        # the same run with every layer off, in this process
        _native.EVENT_LOG = {}
        part_off, solver_off = run_main(
            name, graphs[name][0], kp, counted, dev, metrics,
            device_graph_from_host, torch, "default", EXPECTED_CUTS[name],
            run="observatory off")
        _native.EVENT_LOG = None
        if not np.array_equal(part_off, part):
            fail(f"observatory {name}: the layers changed the partition")
        errors = validate_report(report)
        if errors:
            fail(f"observatory {name}: report {errors[:3]}")
        roofline = check_roofline(f"observatory {name}", report, spied)
        need(f"observatory {name}", record, path_kernels[:2])
        q = report["quality"]
        rows = quality.attribution_rows(report)
        if not rows or not headline:
            fail(f"observatory {name}: no quality attribution")
        worst_locked = max(rows, key=lambda r: r["coarsening_locked"])
        uploads = [r for r in report["ledger"]["transfers"]["rows"]
                   if r["kind"] == "csr-upload"
                   and r["scope"] == "partitioning.device-upload"]
        h2d = sum(r["bytes"] for r in uploads)
        (pad,) = [r for r in report["perf"]["pad_waste"]
                  if r["scope"] == "partitioning.device-upload"]
        csr_bytes = 4 * (2 * pad["n_pad"] + 1 + 3 * pad["m_pad"])
        if h2d != csr_bytes:
            fail(f"observatory {name}: csr-upload {h2d} B, the padded CSR "
                 f"holds {csr_bytes} B")
        if name == "large" and (
                csr_bytes + 4 * pad["n_pad"] != LARGE_LEVEL0_BUFFER_BYTES):
            fail(f"observatory large: the padded CSR {csr_bytes} B and its "
                 "cluster map are not level 0's buffers")
        memory = report["perf"]["memory"]
        if not memory["samples"] or any(
                s.get("bytes_in_use") is None for s in memory["samples"]):
            fail(f"observatory {name}: no allocator samples")
        reports[name] = report
        runs[f"observatory/{name}"] = (record["launches"],
                                       record["path_ms"])
        print(json.dumps({
            "observatory": name, "card": CARD,
            "wall_on_s": round(wall_on, 3),
            "wall_off_s": round(solver_off.smoke_wall, 3),
            "phase5_wall_s": round(main_walls[name], 3),
            "phase_s_on": solver.last_timings,
            "phase_s_off": solver_off.last_timings,
            "launches": record["launches"], "path_ms": record["path_ms"],
            "peaks": report["perf"]["peaks"],
            "totals": report["perf"]["totals"],
            "roofline": roofline,
            "quality_headline": headline,
            "coarsening_locked_max": {
                "level": worst_locked["level"],
                "coarsening_locked": worst_locked["coarsening_locked"]},
            "quality_totals": q["totals"],
            "csr_upload_h2d_bytes": h2d,
            "transfers": report["ledger"]["transfers"]["totals"],
            "by_phase": report["ledger"]["transfers"]["by_phase"],
            "memory_peak_live_bytes": memory["peak_live_bytes"],
            "memory_samples": [
                {k: s.get(k) for k in ("stage", "live_bytes",
                                       "bytes_reserved",
                                       "peak_bytes_in_use")}
                for s in memory["samples"]],
            "build_account": report["compile"],
            "at_s": round(time.perf_counter() - T_START, 1),
        }), flush=True)

    # -- 14c
    spied = {}
    record = {}
    tel.enable()
    try:
        with cost_spy(gather, rating, spied):
            solver = dist_solver(kp, DIST_SHARDS, "scatter", "cuda")
            graph = graphs["medium"][0]
            with counting(counted, torch, record):
                t0 = time.perf_counter()
                part = solver.set_graph(graph).compute_partition(
                    k=K_MAIN, epsilon=0.03, seed=1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        report = build_run_report()
    finally:
        tel.disable()
    src = graph.edge_sources()
    cut = int(graph.edge_weight_array()[
        part[src] != part[graph.adjncy]].sum() // 2)
    pin("observatory dist medium/scatter cut", cut,
        EXPECTED_DIST_CUTS[("medium", "scatter")])
    roofline = check_roofline("observatory dist", report, spied)
    k3_rows = [p for p, row in roofline.items()
               if row["kernels"].get("best_from_slots")]
    if not k3_rows:
        fail("observatory dist: no roofline row launched the standalone K3")
    runs["observatory/dist/medium/scatter"] = (record["launches"],
                                               record["path_ms"])
    print(json.dumps({
        "observatory": "dist medium/scatter", "shards": DIST_SHARDS,
        "cut": cut, "wall_s": round(wall, 3), "card": CARD,
        "launches": record["launches"], "roofline": roofline,
        "standalone_k3_scopes": k3_rows,
        "quality_totals": report["quality"].get("totals"),
        "ranks": report["perf"]["memory"].get("ranks"),
    }), flush=True)

    # -- 14d: the renderers on 14b's large report, and a cold build
    path = os.path.join(tmp, f"{names[0]}.report.json")
    with open(path, "w") as f:
        json.dump(reports[names[0]], f)
    for module in ("top", "quality"):
        # `python -m` in this process (runpy is what -m runs), sparing an
        # interpreter's imports per renderer
        out = io.StringIO()
        argv = sys.argv
        t0 = time.perf_counter()
        sys.argv = [f"kaminpar_tpu_torch.telemetry.{module}", path]
        try:
            with contextlib.redirect_stdout(out), warnings.catch_warnings():
                # the module is imported already; -m would run it afresh
                warnings.simplefilter("ignore", RuntimeWarning)
                runpy.run_module(f"kaminpar_tpu_torch.telemetry.{module}",
                                 run_name="__main__")
            code = 0
        except SystemExit as exc:
            code = exc.code
        finally:
            sys.argv = argv
        if code != 0:
            fail(f"observatory: python -m kaminpar_tpu_torch.telemetry."
                 f"{module} exited {code}")
        print(json.dumps({"observatory_render": module,
                          "wall_s": round(time.perf_counter() - t0, 3),
                          "lines": out.getvalue().splitlines()[:40]}),
              flush=True)
    cache = os.path.join(tmp, "cold-cache")
    cold_report = os.path.join(tmp, "cold.report.json")
    env = dict(subprocess_env(), KAMINPAR_TPU_NATIVE_CACHE_DIR=cache)
    _, _, wall = run_process(
        "observatory: the CLI with a cold build",
        [sys.executable, "-m", "kaminpar_tpu_torch", SMALL_SPEC, "-k",
         "8", "--seed", "1", "--report-json", cold_report],
        env=env, timeout=300)
    with open(cold_report) as f:
        cold = json.load(f)
    built = [b for b in cold["compile"]["builds"] if b["built"]]
    nvcc = [b for b in built if b["tool"] == "nvcc"]
    if not nvcc or any(not b["scope"] for b in nvcc):
        fail("observatory: the cold run built no kernel inside a scope")
    rows = cold["perf"]["roofline"]
    for b in nvcc:
        row = rows.get(b["scope"])
        if row is None or row["build_s"] < b["seconds"]:
            fail(f"observatory: the build of {b['library']} is not taken "
                 f"out of the roofline wall of {b['scope']}")
    print(json.dumps({
        "observatory_cold_build": [
            {k: b[k] for k in ("tool", "library", "seconds", "scope")}
            for b in built],
        "roofline_of_build_scopes": {
            b["scope"]: {k: rows[b["scope"]][k]
                         for k in ("wall_s", "build_s", "launches")}
            for b in nvcc},
        "cli_wall_s": round(wall, 3),
        "phase_14_s": round(time.perf_counter() - t_phase, 1),
        "card": CARD}), flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 15: the 64-bit weight build (KAMINPAR_TPU_64BIT=1), in a process of
# its own (the package reads the flag when it is first imported)
# ---------------------------------------------------------------------------

PHASE_15_ARG = "--phase-15"
# `default` on the heavy copies of the bench graphs (heavy_copy), k=16,
# eps=0.03, seed=1: the cut of the JAX package's CPU run under
# KAMINPAR_TPU_64BIT=1 (PERF.md section 4 gives the command); None: no JAX
# run was made (the heavy large graph is not run on a CPU), the cut is
# recorded
EXPECTED_64BIT_CUTS = {"medium": 19_645_903_661, "large": None}
# the dist cell (heavy medium, 8 shards, the scatter engine): the JAX
# package's dist coarsening raises under x64 (ROADMAP Queue 3), so the pin
# is the cut of the port's own CPU run (PERF.md section 4)
EXPECTED_64BIT_DIST_CUT = 34_631_263_772
I64_MIN, I64_MAX = -(2**63), 2**63 - 1


def heavy_copy(graph, node_lo=1 << 20, node_hi=1 << 21):
    """The graph with tests/test_64bit.py's heavy edge weights (drawn by
    default_rng(1) from [2^15, 2^17), equal in both directions of an
    edge) and node weights drawn by default_rng(2) from [node_lo,
    node_hi): on the medium graph every block of k = 16 weighs about
    6.4e9, past 2^31."""
    from kaminpar_tpu_torch.graphs.host import HostGraph

    ew = np.random.default_rng(1).integers(1 << 15, 1 << 17, graph.m)
    src = graph.edge_sources()
    key = (np.minimum(src, graph.adjncy).astype(np.int64) * (1 << 32)
           + np.maximum(src, graph.adjncy))
    order = np.argsort(key, kind="stable")
    sym = np.empty(graph.m, dtype=np.int64)
    pairs = ew[order].reshape(-1, 2)
    pairs[:, 1] = pairs[:, 0]
    sym[order] = pairs.reshape(-1)
    nw = np.random.default_rng(2).integers(node_lo, node_hi, graph.n)
    return HostGraph(graph.xadj, graph.adjncy, nw.astype(np.int64), sym)


def run_phase_15(graphs, main_walls) -> list:
    """Phase 15 in a child process under KAMINPAR_TPU_64BIT=1, its lines
    echoed; returns the four int64 kernels' entries of the JSON line.  The
    bench graphs' CSR arrays go to the child in .npy files (generating
    the large graph again would take it about 12 s)."""
    env = subprocess_env()
    env["KAMINPAR_TPU_64BIT"] = "1"
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="kp-smoke-phase15-")
    try:
        for name in ("medium", "large"):
            g = graphs[name][0]
            np.save(os.path.join(tmp, f"{name}_xadj.npy"), g.xadj)
            np.save(os.path.join(tmp, f"{name}_adjncy.npy"), g.adjncy)
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), PHASE_15_ARG, tmp],
            cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
        last = ""
        try:
            for line in proc.stdout:
                print(line, end="", flush=True)
                last = line
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if rc != 0:
        fail(f"phase 15 (the 64-bit build) exited {rc}")
    result = json.loads(last)["phase_15"]
    walls = {name: {"64-bit": wall, "32-bit (phase 5)": main_walls[name]}
             for name, wall in result["walls"].items()}
    print(json.dumps({"phase_15_s": round(time.perf_counter() - t0, 1),
                      "walls_s": walls, "card": CARD}), flush=True)
    return result["kernels"]


def int64_entry(name, source, replaces, out, ref, fn, twin, cost, torch,
                library=None, **extra) -> dict:
    """The JSON entry of one int64 kernel at its path shape."""
    b, by, per_launch = cost_bound(cost)
    ms, _, ms_by = device_ms(fn, torch)
    entry = {
        "name": name, "route": "cuda", "weights": "int64",
        "source": source, "replaces": replaces,
        "max_abs_err": max(max_abs_err(o, r) for o, r in zip(out, ref)),
        "ms": ms, "ms_by": ms_by, "call_ms": time_ms(fn, torch),
        "plain_ms": time_ms(twin, torch, reps=5),
        "bound_ms": b, "bound_by": by, "bytes_per_launch": per_launch,
        "cost_function": COST_FUNCTIONS[name],
        # one library call (index_put_ with accumulate takes 1.7 s in
        # int64 on the large graph)
        "library_ms": (None if library is None else
                       time_ms(library, torch, reps=1, warmup=0, batch=1)),
    }
    entry.update(extra)
    return entry


def same(what, out, ref, torch) -> None:
    torch.cuda.synchronize()
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    for o, r in zip(out, ref):
        if o.dtype != r.dtype or not torch.equal(o, r):
            fail(f"{what}: the int64 kernel disagrees with its twin")


def check_int64_kernels(graphs, kp, gather, rating, segments, Coarsener,
                        device_graph_from_host, rng, dev, torch) -> list:
    """Phase 15a: each int64 variant bitwise against its twin on the same
    CUDA tensors at the heavy graphs' level-0 shapes (K1 and K2 on large,
    both K3 on medium) and on edge cases: rows whose connection sums pass
    2^31, cluster weight plus node weight past int64's max beside the cap,
    the int64 sentinel, hashed ties, num_slots 256; timed beside bound,
    twin and (K1, K2) one PyTorch call."""
    t = lambda a, dt=np.int32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dt)).to(dev)
    entries = []
    # -- K1 gather_i64: the edge weights at a delta buffer's compacted
    # edge ids (Jet's delta round on the large graph), then extremes
    dg = device_graph_from_host(graphs["large"][1], dev)
    n_pad, m_pad = dg.n_pad, dg.m_pad
    active = torch.from_numpy(rng.random(n_pad) < 0.6).to(dev)
    _, _, edge_id, valid, _, _ = segments.expand_active_rows(
        dg.row_ptr, dg.degrees, active, m_pad // 4)
    eid = edge_id.clamp(0, m_pad - 1).contiguous()
    out = gather.gather_i64(dg.edge_w, eid)
    ref = gather.gather_i64_twin(dg.edge_w, eid)
    same("K1 gather_i64", out, ref, torch)
    table = t(rng.integers(I64_MIN, I64_MAX, 1 << 20, dtype=np.int64),
              np.int64)
    table[:2] = torch.tensor([I64_MIN, I64_MAX])
    idx = t(rng.integers(0, 1 << 20, 3_000_001))
    for off in range(4):
        view = idx[off: off + 1_000_001]
        same(f"K1 gather_i64 (int64 extremes, offset {off})",
             gather.gather_i64(table, view),
             gather.gather_i64_twin(table, view), torch)
    entries.append(int64_entry(
        "gather_i64", "kaminpar_tpu_torch/csrc/gather.cu",
        "kaminpar_tpu/ops/lane_gather.py:268", [out], [ref],
        lambda: gather.gather_i64(dg.edge_w, eid),
        lambda: gather.gather_i64_twin(dg.edge_w, eid),
        gather.gather_i64_cost(dg.edge_w, eid), torch,
        library=lambda: dg.edge_w[eid],
        shape={"graph": "heavy large", "table": m_pad,
               "idx": int(eid.numel())}))
    del out, ref, table, idx, active, edge_id, valid, eid

    # -- K2 int64: the first refinement's (n_pad, 16) table on large
    part = t(rng.integers(0, K_MAIN, n_pad))
    args2 = (dg.row_ptr[:-1], dg.row_ptr[1:], dg.dst, dg.edge_w, part,
             n_pad, K_MAIN)
    out = gather.dense_block_ratings(*args2)
    ref = gather.dense_block_ratings_twin(*args2)
    same("K2 int64", out, ref, torch)
    # hub rows of 45k edges at weights in [2^40, 2^41) (sums far past
    # 2^31), at k from 2 to beyond the shared-memory design (2048 takes
    # 53 KB of int64 counters)
    deg = rng.integers(0, 24, 1 << 16)
    deg[[7, 31_000, 65_000]] = (45_000, 44_904, 41_000)
    deg[-4000:] = 0
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    hub_m = int(row_ptr[-1])
    hub_spans = (t(row_ptr[:-1]), t(row_ptr[1:]))
    hub_dst = t(rng.integers(0, 1 << 16, hub_m + 1000))
    hub_w = t(rng.integers(1 << 40, 1 << 41, hub_m + 1000), np.int64)
    hub_sum = 0
    for k in (2, 16, 256, 2048, 4096):
        labels = t(rng.integers(-1, k + 1, 1 << 16))
        hargs = (*hub_spans, hub_dst, hub_w, labels, 1 << 16, k)
        hub = gather.dense_block_ratings(*hargs)
        same(f"K2 int64 (hub rows, k={k})", hub,
             gather.dense_block_ratings_twin(*hargs), torch)
        hub_sum = max(hub_sum, int(hub.max()))
    if hub_sum <= 2**31:
        fail("K2 int64 hub case is blind: no connection sum past 2^31")
    library_part = part.clamp(0, K_MAIN - 1)

    def library_k2():
        flat = dg.src.to(torch.int64) * K_MAIN + library_part[dg.dst]
        conn = torch.zeros(n_pad * K_MAIN, dtype=torch.int64, device=dev)
        conn.index_put_((flat,), dg.edge_w, accumulate=True)
        return conn

    entries.append(int64_entry(
        "dense_block_ratings_i64", "kaminpar_tpu_torch/csrc/dense_ratings.cu",
        "kaminpar_tpu/ops/lane_gather.py:451", [out], [ref],
        lambda: gather.dense_block_ratings(*args2),
        lambda: gather.dense_block_ratings_twin(*args2),
        gather.dense_block_ratings_i64_cost(*args2), torch,
        library=library_k2, hub_max_connection=hub_sum,
        shape={"graph": "heavy large", "edges": dg.m, "slots": m_pad,
               "rows": n_pad, "k": K_MAIN}))
    del out, ref, hub, hub_w, hub_dst, dg, part

    # -- K3 on the heavy medium graph's level 0 (every node its own
    # cluster): the scatter slot table, cluster weights around the cap
    # (node weights in [2^20, 2^21)) and every 37th near int64's max, where
    # cw + node_w wraps negative and so passes the mask
    dg = device_graph_from_host(graphs["medium"][1], dev)
    ctx = kp.context_from_preset("default")
    ctx.partition.setup(graphs["medium"][1], k=K_MAIN, epsilon=0.03)
    lp_cfg = Coarsener(ctx, dg, dg.n)._level_lp_cfg(dg)
    if lp_cfg.rating != "scatter":
        fail(f"heavy medium level 0 takes {lp_cfg.rating}, not scatter")
    num_slots, salt = lp_cfg.num_slots, 12345
    ids = dg.node_ids()
    spans = (dg.row_ptr[:-1], dg.row_ptr[1:])
    cap_value, near_max = 3 << 20, I64_MAX - (1 << 19)

    def around_cap(n):
        cw_np = rng.integers(cap_value - (2 << 20), cap_value + 1, n)
        cw_np[::37] = near_max
        return (t(cw_np, np.int64),
                torch.full((n,), cap_value, dtype=torch.int64, device=dev))

    cw, cap = around_cap(dg.n_pad)

    def blind(what, best_fit, best_nofit):
        masked = int((best_fit != best_nofit).sum())
        wrapped = int(((best_fit >= 0)
                       & (cw[best_fit.clamp(min=0)] == near_max)).sum())
        if masked == 0 or wrapped == 0:
            fail(f"{what} check is blind: the mask changed {masked} rows, "
                 f"{wrapped} rows chose a wrapped-feasible label")
        return masked, wrapped

    nb = gather.gather_i32(ids, dg.dst)
    slot_label, slot_w, _ = rating.scatter_slot_ratings(
        dg.src, nb, dg.edge_w, dg.n_pad, num_slots, salt, spans=spans)
    if slot_w.dtype != torch.int64:
        fail("the 64-bit build's slot table is not int64")
    # hashed ties at weights past 2^31, and the int64 sentinel
    tied = torch.where(slot_w > 0, (slot_w % 3 + 1) << 33, slot_w)
    sentinel = slot_w.clone()
    sentinel[::5] = I64_MIN
    cases = {}
    for what, sw in (("level 0", slot_w), ("hashed ties", tied),
                     ("int64 sentinel", sentinel)):
        args3 = (slot_label, sw, ids, cw, dg.node_w, cap, 0x2545F491)
        out = rating.best_from_slots(*args3)
        out_nf = rating.best_from_slots(*args3, require_fit=False)
        same(f"K3 int64 ({what})", out, rating.best_from_slots_twin(*args3),
             torch)
        same(f"K3 int64 ({what}, no fit)", out_nf,
             rating.best_from_slots_twin(*args3, require_fit=False), torch)
        cases[what] = blind(f"K3 int64 ({what})", out[0], out_nf[0])
    args3 = (slot_label, slot_w, ids, cw, dg.node_w, cap, 0x2545F491)
    out = rating.best_from_slots(*args3)
    ref = rating.best_from_slots_twin(*args3)
    rows, S = slot_label.shape
    entries.append(int64_entry(
        "best_from_slots_i64", "kaminpar_tpu_torch/csrc/best_from_slots.cu",
        "kaminpar_tpu/ops/rating.py:377", out, ref,
        lambda: rating.best_from_slots(*args3),
        lambda: rating.best_from_slots_twin(*args3),
        rating.best_from_slots_i64_cost(slot_label, slot_w), torch,
        cases={w: {"masked_rows": m, "wrapped_rows": r}
               for w, (m, r) in cases.items()},
        shape={"graph": "heavy medium", "rows": rows, "slots": S},
        sweep=sweep_k3(rating, torch, dev)))
    print_k3_vs_parent("heavy medium, int64", entries[-1]["ms"])
    del out, ref, tied, sentinel

    # -- the fused K3 int64: the level's spans at the level's num_slots,
    # 256 (48 KB of tables per block), 4 (contested), 48 (no power of
    # two), a delta round's spans cut at the buffer, and hub rows at
    # weights in [2^40, 2^41)
    def fused_case(what, args, check_blind=False):
        res = {}
        for fit in (True, False):
            a = rating.scatter_best_from_slots(*args, require_fit=fit)
            same(f"fused K3 int64 ({what}, require_fit={fit})", a,
                 rating.scatter_best_from_slots_twin(*args,
                                                     require_fit=fit),
                 torch)
            res[fit] = a
        if check_blind:
            blind(f"fused K3 int64 ({what})", res[True][0], res[False][0])
        return int((~res[True][3]).sum())

    level = (*spans, dg.dst, dg.edge_w, ids, cw, dg.node_w, cap)
    fused_args = (*level, num_slots, salt)
    unrated = {s: fused_case(f"level 0, num_slots {s}", (*level, s, salt),
                             check_blind=s == num_slots)
               for s in (num_slots, 256, 4, 48)}
    if unrated[4] == 0:
        fail("fused K3 int64 at num_slots 4 is blind: every row rated")
    active = torch.from_numpy(rng.random(dg.n_pad) < 0.6).to(dev)
    _, _, edge_id, valid, start, end = segments.expand_active_rows(
        dg.row_ptr, dg.degrees, active, dg.m_pad // 4)
    eid = edge_id.clamp(0, dg.m_pad - 1)
    fused_case("delta spans cut at the buffer", (
        start, end, torch.where(valid, dg.dst[eid], dg.n_pad - 1),
        torch.where(valid, gather.gather_i64(dg.edge_w, eid), 0), ids, cw,
        dg.node_w, cap, num_slots, salt))
    hub_cw, hub_cap = around_cap(1 << 16)
    hub_args = (*hub_spans, t(rng.integers(0, 1 << 16, hub_m)),
                t(rng.integers(1 << 40, 1 << 41, hub_m), np.int64),
                t(rng.integers(0, 1 << 16, 1 << 16)), hub_cw,
                t(rng.integers(1 << 20, 1 << 21, 1 << 16), np.int64),
                hub_cap, num_slots, salt)
    fused_case("hub rows", hub_args)
    out = rating.scatter_best_from_slots(*fused_args)
    ref = rating.scatter_best_from_slots_twin(*fused_args)
    entries.append(int64_entry(
        "scatter_best_from_slots_i64",
        "kaminpar_tpu_torch/csrc/best_from_slots.cu",
        "kaminpar_tpu/ops/rating.py:377", out, ref,
        lambda: rating.scatter_best_from_slots(*fused_args),
        lambda: rating.scatter_best_from_slots_twin(*fused_args),
        rating.scatter_best_from_slots_i64_cost(*fused_args), torch,
        unrated_rows=unrated,
        ms_256=device_ms(lambda: rating.scatter_best_from_slots(
            *level, 256, salt), torch)[0],
        shape={"graph": "heavy medium", "rows": dg.n_pad, "edges": dg.m,
               "num_slots": num_slots, "hub_edges": hub_m}))
    print(json.dumps({"int64_kernel_checks": "ok"}), flush=True)
    return entries


def check_int64_blocks(what, graph, partition, caps) -> None:
    """Every block weight, recounted in int64 on the host, within its
    cap."""
    bw = np.zeros(K_MAIN, dtype=np.int64)
    np.add.at(bw, partition.astype(np.int64), graph.node_weight_array())
    if (bw > np.asarray(caps, dtype=np.int64)).any():
        fail(f"{what}: block weights {bw.tolist()} over the caps "
             f"{np.asarray(caps).tolist()}")
    if bw.max() <= 2**31:
        fail(f"{what}: no block weighs past 2^31, the cell proves little")


def check_heavy_extras(kp, g_small, g_med, core_med, med_part, counted, dev,
                       metrics, device_graph_from_host, CSRInvariantError,
                       torch) -> None:
    """Phase 15b: the heavy n = 2^14 graph on the CPU and the card,
    bitwise; 15f: KAMINPAR_TPU_ASSERTS=1 leaves the heavy medium
    partition, and a graph corrupted after set_graph is refused at the
    output gate (the input CSR is validated there)."""
    parts = {device: kp.KaMinPar("default", device=device).set_graph(
        g_small).compute_partition(k=8, epsilon=0.03, seed=1)
        for device in ("cpu", "cuda")}
    if not np.array_equal(parts["cpu"], parts["cuda"]):
        fail("heavy n=2^14: CPU and CUDA partitions differ in "
             f"{int((parts['cpu'] != parts['cuda']).sum())} nodes")
    print(json.dumps({"heavy_small_parity": "bitwise-equal"}), flush=True)
    part, _ = run_main("heavy medium, asserts", g_med, kp, counted, dev,
                       metrics, device_graph_from_host, torch, "default",
                       EXPECTED_64BIT_CUTS["medium"],
                       env={"KAMINPAR_TPU_ASSERTS": "1"})
    if not np.array_equal(part, med_part):
        fail("KAMINPAR_TPU_ASSERTS=1 changed the heavy medium partition")
    bad = graph_copy(core_med)
    bad.adjncy = bad.adjncy.copy()
    solver = kp.KaMinPar("default", device="cuda").set_graph(bad)
    bad.adjncy[0] = (bad.adjncy[0] + 2) % bad.n
    try:
        with env_scope({"KAMINPAR_TPU_ASSERTS": "1"}):
            solver.compute_partition(k=K_MAIN, epsilon=0.03, seed=1)
        fail("a corrupted graph passed the output gate")
    except CSRInvariantError as exc:
        if "(at output-gate)" not in str(exc):
            fail(f"the corrupted graph was refused elsewhere: {exc}")
        refused = str(exc)
    print(json.dumps({"asserts": "partition unchanged",
                      "corrupted_graph": refused}), flush=True)


def phase_15_main(graph_dir) -> None:
    """Phase 15 (run by run_phase_15 under KAMINPAR_TPU_64BIT=1, the bench
    graphs' CSR arrays in `graph_dir`): (a) the int64 kernels against
    their twins, (c) `default` on the heavy medium and large graphs, (d)
    dKaMinPar on the heavy medium graph on 8 shards with the scatter
    engine, then, while (e) both command lines run in subprocesses, (b)
    CPU against card at n = 2^14 and (f) KAMINPAR_TPU_ASSERTS=1 and a
    corrupted graph refused at the output gate (none of b, e, f is
    timed)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch import _native, dtypes
    from kaminpar_tpu_torch.graphs.csr import (
        CSRInvariantError,
        device_graph_from_host,
    )
    from kaminpar_tpu_torch.graphs.factories import make_rmat
    from kaminpar_tpu_torch.graphs.host import (
        HostGraph,
        remove_isolated_nodes,
    )
    from kaminpar_tpu_torch.io.metis import write_metis
    from kaminpar_tpu_torch.ops import gather, metrics, rating, segments
    from kaminpar_tpu_torch.partitioning.coarsener import Coarsener
    from kaminpar_tpu_torch.utils.logger import OutputLevel, set_output_level

    if not dtypes.X64_WEIGHTS or dtypes.ACC_DTYPE != torch.int64:
        fail("phase 15 runs without the 64-bit weight build")
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    set_output_level(OutputLevel.QUIET)
    install_event_spy()
    dev = torch.device("cuda")
    _native.build()
    t0 = time.perf_counter()

    def at():
        return round(time.perf_counter() - t0, 1)

    graphs = {}
    for name in ("medium", "large"):
        g = heavy_copy(HostGraph(*(
            np.load(os.path.join(graph_dir, f"{name}_{a}.npy"))
            for a in ("xadj", "adjncy"))))
        core, _, _ = remove_isolated_nodes(g)
        graphs[name] = (g, core)
        print(json.dumps({"heavy_graph": name, "n": g.n, "m": g.m,
                          "total_node_weight": int(g.total_node_weight),
                          "total_edge_weight": int(g.edge_weights.sum()),
                          "at_s": at()}), flush=True)

    # -- 15a
    kernels = check_int64_kernels(graphs, kp, gather, rating, segments,
                                  Coarsener, device_graph_from_host,
                                  np.random.default_rng(15), dev, torch)
    torch.cuda.empty_cache()
    print(json.dumps({"int64_kernels_done_at_s": at()}), flush=True)

    # -- 15c: default on the heavy graphs, each counted from zero
    i64 = (gather.gather_i64, gather.dense_block_ratings_i64,
           rating.best_from_slots_i64, rating.scatter_best_from_slots_i64)
    i32 = (gather.gather_i32, gather.dense_block_ratings,
           rating.best_from_slots, rating.scatter_best_from_slots)
    counted = i64 + i32
    need_on = {"large": (gather.gather_i64, gather.dense_block_ratings_i64),
               "medium": (gather.dense_block_ratings_i64,
                          rating.scatter_best_from_slots_i64)}
    launches = {fn.__name__: 0 for fn in i64}
    path_ms = {fn.__name__: {} for fn in i64}
    main_parts, walls = {}, {}
    for name in ("large", "medium"):
        with counting(counted, torch, {}) as record:
            main_parts[name], solver = run_main(
                f"heavy {name}", graphs[name][0], kp, counted, dev, metrics,
                device_graph_from_host, torch, "default",
                EXPECTED_64BIT_CUTS[name])
        need(f"heavy {name}", record, need_on[name])
        for fn in (gather.dense_block_ratings, rating.best_from_slots,
                   rating.scatter_best_from_slots):
            if record["launches"][fn.__name__]:
                fail(f"heavy {name}: the int32 kernel {fn.__name__} ran "
                     "in the 64-bit build")
        check_int64_blocks(f"heavy {name}", graphs[name][0],
                           main_parts[name],
                           solver.ctx.partition.unrelaxed_max_block_weights)
        walls[name] = solver.smoke_wall
        for fn in i64:
            launches[fn.__name__] += record["launches"][fn.__name__]
            path_ms[fn.__name__][name] = record["path_ms"].get(
                fn.__name__, 0.0)
        print(json.dumps({"heavy_cell": name, **record, "card": CARD,
                          "at_s": at()}), flush=True)

    # -- 15d: dKaMinPar on the heavy medium graph, 8 shards, scatter
    g_med = graphs["medium"][0]
    with counting(counted, torch, {}) as record:
        solver = dist_solver(kp, DIST_SHARDS, "scatter", "cuda")
        t1 = time.perf_counter()
        dpart = solver.set_graph(g_med).compute_partition(
            k=K_MAIN, epsilon=0.03, seed=1)
        torch.cuda.synchronize()
        dist_wall = time.perf_counter() - t1
    need("heavy medium, 8 shards, scatter", record,
         (rating.best_from_slots_i64, gather.dense_block_ratings_i64))
    check_int64_blocks("heavy medium dist", g_med, dpart,
                       solver.ctx.partition.unrelaxed_max_block_weights)
    src = g_med.edge_sources()
    dist_cut = int(g_med.edge_weights[dpart[src] != dpart[g_med.adjncy]]
                   .sum() // 2)
    if EXPECTED_64BIT_DIST_CUT is not None and (
            dist_cut != EXPECTED_64BIT_DIST_CUT):
        fail(f"heavy medium dist: cut {dist_cut}, the port's CPU run's is "
             f"{EXPECTED_64BIT_DIST_CUT}")
    for fn in i64:
        launches[fn.__name__] += record["launches"][fn.__name__]
        path_ms[fn.__name__]["medium dist"] = record["path_ms"].get(
            fn.__name__, 0.0)
    print(json.dumps({"heavy_dist": "medium/scatter", "cut": dist_cut,
                      "pinned": EXPECTED_64BIT_DIST_CUT,
                      "wall_s": dist_wall, "levels": solver.last_levels,
                      **record, "card": CARD, "at_s": at()}), flush=True)

    # -- 15e: both command lines under the flag, side by side; 15b and
    # 15f run in this process meanwhile
    tmp = tempfile.mkdtemp(prefix="kp-smoke-64bit-")
    try:
        path = os.path.join(tmp, "heavy_medium.metis")
        write_metis(g_med, path)
        common = [path, "-k", str(K_MAIN), "-e", "0.03", "--seed", "1", "-q"]
        cmds = {
            "cli": [sys.executable, "-m", "kaminpar_tpu_torch", *common,
                    "-o", os.path.join(tmp, "cli.part")],
            "dcli": [sys.executable, "-m", "kaminpar_tpu_torch.dcli",
                     *common, "-n", str(DIST_SHARDS), "--lp-rating",
                     "scatter", "-o", os.path.join(tmp, "dcli.part")],
        }
        env = subprocess_env()
        t1 = time.perf_counter()
        procs = {w: subprocess.Popen(c, cwd=REPO, env=env,
                                     stdout=subprocess.DEVNULL,
                                     stderr=subprocess.PIPE, text=True)
                 for w, c in cmds.items()}
        check_heavy_extras(kp, heavy_copy(make_rmat(1 << 14, 120_000,
                                                    seed=3)),
                           g_med, graphs["medium"][1], main_parts["medium"],
                           counted, dev, metrics, device_graph_from_host,
                           CSRInvariantError, torch)
        for what, proc in procs.items():
            _, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                fail(f"the {what} under KAMINPAR_TPU_64BIT=1 exited "
                     f"{proc.returncode}: {err[-2000:]}")
        cli_s = time.perf_counter() - t1
        for what, want in (("cli", main_parts["medium"]), ("dcli", dpart)):
            got = np.loadtxt(os.path.join(tmp, f"{what}.part"),
                             dtype=np.int64)
            if not np.array_equal(got, want):
                fail(f"the {what}'s partition is not the in-process one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"heavy_command_lines": "same partitions",
                      "wall_s": cli_s, "at_s": at()}), flush=True)

    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        entry["launches_from"] = "phase 15c-d"
        entry["path_ms"] = path_ms[entry["name"]]
        entry["on_path"] = entry["launches"] > 0
        entry["ok"] = True
    print(json.dumps({"phase_15": {"kernels": kernels, "walls": walls,
                                   "dist_cut": dist_cut}}), flush=True)


def install_event_spy() -> None:
    """Record the resilience layer's events in RESILIENCE_EVENTS, whether
    or not telemetry records them."""
    from kaminpar_tpu_torch import telemetry

    event = telemetry.event

    def spy(name, **attrs):
        if name in ("degraded", "memory-budget", "memory-pressure",
                    "memory-spill", "memory-reload", "deadline",
                    "integrity", "checkpoint", "resume"):
            RESILIENCE_EVENTS.append((name, dict(attrs)))
        return event(name, **attrs)

    telemetry.event = spy


def loud_events() -> list:
    """The recorded events a plain run must not leave: a degradation, a
    rung, a spill, a wind-down or an integrity violation."""
    return [(n, a) for n, a in RESILIENCE_EVENTS
            if n in ("degraded", "memory-budget", "memory-pressure",
                     "memory-spill", "deadline")
            or (n == "integrity" and a.get("action") != "chaos-corrupt")]


if __name__ == "__main__":
    if sys.argv[1:2] == [PHASE_15_ARG] and len(sys.argv) == 3:
        phase_15_main(sys.argv[2])
    else:
        main()
