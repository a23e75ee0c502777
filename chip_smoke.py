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
     standalone K3);
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
  7b. those paths at full width: `strong`, `mtkahypar-kway` and `vcycle`
     on the medium graph, k=16, eps=0.03, seed=1, each checked as in
     phase 5, with its cut held against the JAX package's cut for the
     same graph, preset and seed (EXPECTED_PRESET_CUTS); the path's
     kernels must launch in each run, whose launches and `path_ms` are
     counted from zero.  `strong` on the large graph is left out: its
     single-threaded host FM passes over 572,702 nodes ran past 240 s
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
  Phases 5, 7b, 8b and 9b fail on any degradation, rung, spill,
     wind-down or integrity-violation event (run_main);
  6. print the per-kernel JSON line, then the final status line.

The rating engine is chosen per level from the graph's density: the large
graph (average degree 33 > 32 slots) takes the sort2 engine at every
level and never reaches K3, the medium graph (average degree 26) takes
the scatter engine, which is the fused K3.  So the main path is both
graphs.  The standalone K3 (the table's arg-max alone) is no longer on
it: it is checked and timed in phase 3 and shows 0 launches.

Takes no arguments.  Exits non-zero without a result when CUDA is
unavailable or the package is missing.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
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
    ("medium", "strong"): 244_663,
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
    ("large", "default, from compressed"): 2_971_596,
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
    b, by = bound_ms(4 * m_pad + 4 * n_pad + 4 * m_pad, 0)
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
    b, by = bound_ms(8 * n_pad + 8 * dg.m + 4 * n_pad + 4 * n_pad * K_MAIN,
                     dg.m)
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
    main_parts = {}
    for name, n, m, seed in main_runs:
        _native.EVENT_LOG = {}
        native.ml_bipartition.calls = 0
        main_parts[name], _ = run_main(
            name, graphs[name][0], kp, counted, dev, metrics,
            device_graph_from_host, torch, "default", EXPECTED_CUTS[name])
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

    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        entry["path_ms"] = path_ms[entry["name"]]
        for run, (run_launches, run_ms) in slice_runs.items():
            entry.setdefault("path_launches", {})[run] = (
                run_launches[entry["name"]])
            entry["path_ms"][run] = run_ms.get(entry["name"], 0.0)
        entry["on_path"] = entry["name"] != "best_from_slots"
        entry["ok"] = True
        if entry["name"] == "scatter_best_from_slots":
            entry["communities"] = communities
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
        compressed = load_timed("large compressed", files["compressed"][0],
                                kp, g_large, cg_large)
        lazy = load_timed("large lazy compressed", files["compressed"][0],
                          kp, g_large, cg_large, lazy=True)
        calls = native.parse_metis_body.calls
        metis = load_timed("medium metis", files_med["metis"][0], kp,
                           g_med, None)
        if native.parse_metis_body.calls != calls + 1:
            fail("medium metis: the native tokenizer did not read the file")

        runs = [
            ("large", "default, from ParHiP", "default", None, parhip, None),
            ("large", "default, from compressed", "default", None,
             compressed, None),
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


def k3_bound_ms(rows: int, edges: int, num_slots: int) -> tuple:
    """Bound of the fused K3 over `rows` rows whose spans hold `edges`
    edges: the spans (8 per row), each edge's dst and w (8) and its label
    gather (4), labels, node weights, cluster weights and caps (16 per
    row) and the outputs (13 per row) moved once; about three hashes and
    a few compares per edge (40 operations) and one hash and a few
    compares per slot of the 2 * num_slots (16)."""
    return bound_ms(37 * rows + 12 * edges,
                    40 * edges + 16 * rows * 2 * num_slots)


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
    # slot tables once, labels/node weights/cluster weights/caps once,
    # three outputs; one hash and a handful of compares per slot
    b, by = bound_ms(8 * rows * S + 16 * rows + 12 * rows, 16 * rows * S)
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
        "library_ms": None,
        "shape": {"graph": "medium", "rows": rows, "slots": S},
    }
    del outs, refs, outs_nf, refs_nf

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

    b, by = k3_bound_ms(dg.n_pad, dg.m, num_slots)
    hub_b, _ = k3_bound_ms(1 << 16, hub_m, num_slots)
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
    main()
