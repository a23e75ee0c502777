"""Distributed deep-multilevel partitioner facade (counterpart of
kaminpar_tpu/parallel/dist_partitioner.py, the dKaMinPar analog).

  coarsening   distributed LP clustering over the shard mesh
               (dist_lp.dist_lp_cluster), the singleton post-passes on
               the host, then contraction: by the single-device kernel
               (ops/contraction) up to ``segments.MAX_FUSED_EDGE_SLOTS``
               edges, by the sharded contraction (dist_contraction) above;
               the coarse CSR returns to the host to be re-sharded.  Once
               the graph is too small for the mesh (deep mode),
               mesh-subgroup replication coarsens G replicas as one union
               graph and keeps the best replica's partition;
  initial      the coarsest graph is partitioned by this package's
  partitioning shared-memory KaMinPar (one seeded run per replica, the
               best cut kept), or by the RANDOM partitioner;
  uncoarsening project up through the cluster maps and refine on the mesh
               (node balancer, then batched LP); deep mode doubles k on
               the way up by bipartitioning each block on the host.

Every barrier of the JAX driver is here (checkpoints and a resume that
rebuilds the hierarchy, the agreed deadline wind-down, the divergence
sentinels, the agreed OOM ladder with the spiller hook).  The run
report's quality, perf and tracing sections of the JAX package are not
ported.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import telemetry
from ..context import Context, PartitioningMode
from ..device import DeviceLike
from ..dtypes import WEIGHT_DTYPE, WMAX
from ..graphs.csr import device_graph_from_host, host_graph_from_device
from ..graphs.host import HostGraph
from ..ops import segments
# graphs above this many edges take the sharded contraction (a module
# name, as in the JAX package, so that tests can force that path)
from ..ops.segments import MAX_FUSED_EDGE_SLOTS
from ..ops.contraction import contract_clustering
from ..utils import timer
from ..utils.logger import log
from .dist_context import (
    DistContext,
    create_dist_clusterer,
    create_dist_context_by_preset_name,
    create_dist_refiner,
)
from .dist_contraction import dist_contract_clustering
from .dist_graph import (
    DistGraph,
    dist_graph_from_compressed,
    dist_graph_from_host,
)
from .dist_metrics import dist_edge_cut
from .mesh import Mesh, comm_phase, make_mesh, reset_comm_log

# the phases whose walls compute_partition records in last_timings
PHASES = ("dist-coarsening", "dist-replicated-coarsening",
          "dist-initial-partitioning", "dist-uncoarsening", "output-gate")


class dKaMinPar:
    """Distributed partitioner with the dKaMinPar builder surface, over a
    mesh of D shards (on ``device``, ``"cuda"`` unless the caller asks for
    ``"cpu"``)."""

    def __init__(
        self,
        ctx: Union[DistContext, Context, str, None] = None,
        mesh: Optional[Mesh] = None,
        n_devices: Optional[object] = None,
        device: DeviceLike = "cuda",
    ):
        if ctx is None:
            ctx = create_dist_context_by_preset_name("default")
        elif isinstance(ctx, str):
            ctx = create_dist_context_by_preset_name(ctx)
        elif isinstance(ctx, Context):
            ctx = DistContext(shm=ctx)
        self.ctx = ctx
        self.mesh = (mesh if mesh is not None
                     else make_mesh(n_devices, device=device))
        self._graph = None
        self._plain_cache: Optional[Tuple[object, HostGraph]] = None
        self._fine_dg: Optional[DistGraph] = None
        self._replication_info: Optional[dict] = None
        self._levels: Optional[List["_DistLevel"]] = None
        self._shard_fps: List[str] = []
        # wall seconds of the dist phases of the last run, and the (n, m)
        # and per-shard edge counts of each sharded level
        self.last_timings: Dict[str, float] = {}
        self.last_levels: List[dict] = []

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def set_graph(self, graph) -> "dKaMinPar":
        """A HostGraph or a CompressedHostGraph (kept compressed: the
        finest level is sharded from the compressed rows)."""
        self._graph = graph
        self._plain_cache = None
        self._fine_dg = None
        return self

    def _is_compressed(self, g) -> bool:
        from ..graphs.compressed import CompressedHostGraph

        return isinstance(g, CompressedHostGraph)

    def _plain(self, g) -> HostGraph:
        if not self._is_compressed(g):
            return g
        if self._plain_cache is None or self._plain_cache[0] is not g:
            self._plain_cache = (g, g.decode())
        return self._plain_cache[1]

    def set_output_level(self, level) -> "dKaMinPar":
        """Instance-scoped output level: applied while compute_partition
        runs."""
        from ..utils.logger import OutputLevel

        self._output_level = OutputLevel(level)
        return self

    def copy_graph(self, vtxdist, xadj, adjncy, vwgt=None, adjwgt=None):
        """ParMETIS-style ingestion; vtxdist is accepted for API parity."""
        self._graph = HostGraph(
            xadj=np.asarray(xadj),
            adjncy=np.asarray(adjncy, dtype=np.int32),
            node_weights=None if vwgt is None else np.asarray(vwgt),
            edge_weights=None if adjwgt is None else np.asarray(adjwgt),
        )
        self._plain_cache = None
        self._fine_dg = None
        return self

    def _dist_graph(self, host) -> DistGraph:
        if self._is_compressed(host):
            dg = dist_graph_from_compressed(host, self.mesh)
        else:
            dg = dist_graph_from_host(host, self.mesh)
        from .dist_graph import shard_sizes

        _, _, counts = shard_sizes(np.asarray(host.xadj), self.mesh.size)
        self.last_levels.append({"n": int(host.n), "m": int(host.m),
                                 "shard_edges": counts})
        return dg

    def compute_partition(self, k: Optional[int] = None,
                          epsilon: Optional[float] = None,
                          seed: Optional[int] = None) -> np.ndarray:
        if self._graph is None:
            raise RuntimeError("no graph set")
        graph = self._graph
        ctx = self.ctx
        if seed is not None:
            ctx.seed = int(seed)
        ctx.partition.setup(graph, k=k, epsilon=epsilon)
        k = ctx.partition.k
        from ..resilience import agreement as agreement_mod
        from ..resilience import checkpoint as ckpt_mod
        from ..resilience import deadline as deadline_mod
        from ..resilience import memory as memory_mod
        from ..resilience import supervisor as supervisor_mod
        from ..utils.logger import output_level, set_output_level
        from .dist_graph import shard_fingerprints, shard_sizes

        self.last_timings = {}
        self.last_levels = []
        owns_stream = timer.GLOBAL_TIMER.idle()
        mgr = None
        res_ctx = ctx.shm.resilience
        t_run0 = time.perf_counter()
        # the hard wall-clock watchdog, armed as the shm facade arms it
        hard_ceiling_s = None
        if owns_stream:
            timer.GLOBAL_TIMER.reset()
            telemetry.reset()
            telemetry.annotate(
                seed=int(ctx.seed), k=int(k),
                epsilon=float(ctx.partition.epsilon),
                mode=ctx.mode.value, devices=int(self.mesh.size),
                graph={"n": int(graph.n), "m": int(graph.m)},
            )
            ckpt_mod.deactivate()
            deadline_mod.begin_run(res_ctx.time_budget or None,
                                   res_ctx.budget_grace,
                                   res_ctx.hard_deadline_factor)
            # a fresh run state: this run's comm account starts empty
            reset_comm_log()
            mgr = ckpt_mod.create_manager(res_ctx, graph, ctx)
            if mgr is not None:
                ckpt_mod.activate(mgr)
            devices = max(1, int(self.mesh.size))
            self._shard_fps = shard_fingerprints(graph, devices)
            if mgr is not None:
                pending = mgr.pending_resume()
                if pending is not None and pending.get("scheme") == "dist":
                    recorded = pending.get("meta", {}).get("shards")
                    if (recorded is not None
                            and list(recorded) != list(self._shard_fps)):
                        mgr.drop_resume(
                            "dist shard fingerprints changed (checkpoint "
                            f"has {len(list(recorded))} shard(s), current "
                            f"mesh has {len(self._shard_fps)}) — device "
                            "count or input sharding differs"
                        )
            # the budget is per device: price the heaviest padded shard
            n_loc, m_loc, _ = shard_sizes(
                np.asarray(graph.xadj, dtype=np.int64), devices)
            memory_mod.begin_run(graph, ctx, self.device,
                                 price_shape=(n_loc, m_loc))
            memory_mod.register_spiller(self)
            memory_mod.preflight(n_loc, m_loc, k, where="dist")
            hard_ceiling_s = supervisor_mod.hard_ceiling(
                res_ctx.time_budget, res_ctx.budget_grace,
                res_ctx.hard_deadline_factor)
            agreement_mod.arm(
                "dist", ckpt_mod.graph_fingerprint(graph),
                ckpt_mod.ctx_fingerprint(ctx), self._shard_fps,
            )

        prior_level = output_level()
        try:
            set_output_level(getattr(self, "_output_level", prior_level))
            with supervisor_mod.stage_guard("partition", hard_ceiling_s), \
                    timer.scoped_timer("dist-partitioning",
                                       sync=self.device):
                resumed = (mgr.take_result_resume() if mgr is not None
                           else None)
                if resumed is not None and resumed.shape == (graph.n,):
                    partition = resumed
                else:
                    partition = memory_mod.run_dist_ladder(
                        lambda: self._partition(graph, k), graph, ctx,
                        self,
                    )
            if res_ctx.output_gate:
                from ..resilience import gate as output_gate

                partition = np.asarray(partition, dtype=np.int32)
                with timer.scoped_timer("output-gate"):
                    partition, verdict = output_gate.check_and_repair(
                        graph, partition, ctx.partition,
                        repair=res_ctx.repair,
                    )
                if owns_stream:
                    telemetry.annotate(output_gate=verdict)
            cut, imbalance, feasible = self._result_metrics(graph,
                                                            partition, k)
            if owns_stream:
                telemetry.annotate(result={
                    "cut": int(cut), "imbalance": float(imbalance),
                    "feasible": feasible,
                })
                self._finish_resilience(mgr, partition)
            log(
                f"RESULT cut={cut} imbalance={imbalance:.6f} "
                f"k={k} devices={self.mesh.size}"
            )
            # request tracing (telemetry/tracing.py): a served request
            # that drove this compute gets a rank-annotated span
            from ..telemetry import tracing

            tid = tracing.current()
            if tid:
                tracing.span(
                    tid, "dist-compute", start=t_run0,
                    duration_s=time.perf_counter() - t_run0,
                    origin="dist", rank=agreement_mod.process_index(),
                    devices=int(self.mesh.size), k=int(k),
                )
        finally:
            set_output_level(prior_level)
            if owns_stream:
                agreement_mod.disarm()
            self._levels = None
        root = ("dist-partitioning",)
        for phase in PHASES:
            wall = timer.GLOBAL_TIMER.elapsed(*root, phase) or (
                timer.GLOBAL_TIMER.elapsed(phase))
            if wall:
                self.last_timings[phase] = wall
        self.last_timings["total"] = timer.GLOBAL_TIMER.elapsed(*root)
        return partition

    def _result_metrics(self, graph, partition, k):
        """(cut, imbalance, feasible) of the final partition; a still
        compressed input takes its cut from the finest sharded graph."""
        ctx = self.ctx
        if self._is_compressed(graph) and self._fine_dg is not None:
            import math as pymath

            full = np.zeros(self._fine_dg.n_pad, dtype=np.int32)
            full[: graph.n] = partition
            from ..resilience.policy import with_fallback

            fine_dg = self._fine_dg
            cut = with_fallback(
                lambda: dist_edge_cut(fine_dg, torch.from_numpy(full)),
                lambda exc: self._host_cut(self._plain(graph), partition),
                site="collective", where="dist-result-cut",
            )
            nw = graph.node_weight_array()
            bw = np.zeros(k, dtype=np.int64)
            np.add.at(bw, partition, nw)
            perfect = max(1, pymath.ceil(int(nw.sum()) / k))
            imbalance = float(bw.max() / perfect - 1.0)
            feasible = bool((bw <= ctx.partition.max_block_weights).all())
            self._fine_dg = None
            return cut, imbalance, feasible
        from ..graphs.host import host_partition_metrics

        res = host_partition_metrics(self._plain(graph), partition, k)
        feasible = bool(
            (res["block_weights"] <= ctx.partition.max_block_weights).all())
        return res["cut"], res["imbalance"], feasible

    def _finish_resilience(self, mgr, partition) -> None:
        from ..resilience import agreement as agreement_mod
        from ..resilience import checkpoint as ckpt_mod
        from ..resilience import deadline as deadline_mod
        from ..resilience import memory as memory_mod

        if mgr is not None and mgr.enabled:
            final_part = partition
            ckpt_mod.barrier(
                "result", scheme="dist-facade",
                payload=lambda: {"state": {
                    "partition": np.asarray(final_part, dtype=np.int32),
                }},
            )
        if deadline_mod.triggered():
            telemetry.annotate(anytime=deadline_mod.state())
        if mgr is not None:
            telemetry.annotate(checkpoint=mgr.summary())
        mem_summary = memory_mod.summary()
        if mem_summary.get("enabled"):
            telemetry.annotate(memory_budget=mem_summary)
        dist_sect = agreement_mod.section()
        if dist_sect.get("enabled"):
            dist_sect["shard_fingerprints"] = list(self._shard_fps)
            dist_sect["ladder"] = {
                "agreed": True,
                "rung": int(mem_summary.get("rung", 0) or 0),
            }
            if mgr is not None and mgr.resumed_from() is not None:
                dist_sect["resumed_from"] = mgr.resumed_from()
            telemetry.annotate(dist_resilience=dist_sect)
        ckpt_mod.deactivate()

    # -- multilevel driver ------------------------------------------------

    def _partition(self, graph, k: int) -> np.ndarray:
        from ..resilience import checkpoint as ckpt

        ctx = self.ctx
        c_ctx = ctx.coarsening
        total_node_weight = ctx.partition.total_node_weight
        clusterer = create_dist_clusterer(ctx)
        refiner = create_dist_refiner(ctx)
        deep = ctx.mode == PartitioningMode.DEEP
        sync = self.device

        resume = ckpt.take_resume("dist")
        r_stage: Optional[str] = None
        r_level: Optional[int] = None
        levels: List[_DistLevel] = []
        current = graph
        partition: Optional[np.ndarray] = None
        spans = None
        current_k: Optional[int] = None
        num_levels_meta: Optional[int] = None
        if resume is not None:
            r_stage = resume["stage"]
            r_level = resume.get("level")
            meta = resume.get("meta", {})
            levels, current = self._restore_dist_levels(graph,
                                                        resume["arrays"])
            state = resume["arrays"].get("state")
            if (r_stage in ("dist-initial", "dist-uncoarsen")
                    and state is not None and "partition" in state
                    and "spans" in state):
                partition = np.asarray(state["partition"], dtype=np.int32)
                spans = [(int(f), int(c))
                         for f, c in np.asarray(state["spans"]).tolist()]
                current_k = int(meta.get("current_k", len(spans)))
                num_levels_meta = meta.get("num_levels")
            else:
                r_stage = "dist-coarsen"
            telemetry.event(
                "resume", scheme="dist", stage=r_stage, level=r_level,
                levels_restored=len(levels),
            )
            log(
                f"resumed dist pipeline at {r_stage}"
                f"{'' if r_level is None else ':' + str(r_level)} "
                f"({len(levels)} hierarchy level(s) restored)"
            )
        self._levels = levels

        skip_to_uncoarsen = partition is not None
        threshold = max(2 * c_ctx.contraction_limit, k)
        if not skip_to_uncoarsen:
            with timer.scoped_timer("dist-coarsening", sync=sync):
                while current.n > threshold:
                    if deep and self._replication_factor(current.n) > 1:
                        break
                    dg = self._dist_graph(current)
                    if self._is_compressed(current):
                        self._fine_dg = dg
                    mcw = max(1, c_ctx.max_cluster_weight(
                        current.n, total_node_weight, ctx.partition))
                    lvl_seed = (ctx.seed * 7919 + len(levels) * 31337
                                ) & 0x7FFFFFFF
                    with comm_phase(f"coarsening-L{len(levels)}"):
                        labels = clusterer(dg, min(mcw, WMAX), lvl_seed)
                    from .dist_lp import dist_singleton_postpasses

                    fine = current
                    labels = dist_singleton_postpasses(
                        current, labels, min(mcw, WMAX),
                        materialize=lambda: self._plain(fine),
                    )
                    contracted = self._contract_level(current, dg, labels)
                    if contracted is None:
                        break
                    coarse, cmap = contracted
                    fine_n = int(current.n)
                    levels.append(_DistLevel(current, cmap, dg, self))
                    current = coarse
                    lvl_no = len(levels)
                    if not ckpt.barrier(
                        "dist-coarsen", level=lvl_no, scheme="dist",
                        payload=lambda c=coarse, cm=cmap, fn=fine_n,
                        no=lvl_no: _dist_level_payload(no, c, cm, fn),
                        keep=[f"dist-level-{j}" for j in range(1, lvl_no)],
                        meta=self._dist_meta(num_levels=lvl_no),
                        agree=True,
                    ):
                        break

        replicated = False
        if (not skip_to_uncoarsen and deep and current.n > threshold
                and self._replication_factor(current.n) > 1):
            with timer.scoped_timer("dist-replicated-coarsening",
                                    sync=sync):
                partition, ip_k = self._replicated_phase(
                    self._plain(current), k, clusterer, threshold)
            replicated = True

        if skip_to_uncoarsen:
            ip_k = int(current_k)
        elif replicated:
            pass
        elif deep and levels:
            from ..partitioning.deep import compute_k_for_n

            ip_k = max(2, min(k, compute_k_for_n(current.n, ctx.shm)))
        else:
            ip_k = k
        if spans is None:
            spans = self._initial_spans(ip_k, k)

        best_cut = None
        if not replicated and not skip_to_uncoarsen:
            with timer.scoped_timer("dist-initial-partitioning", sync=sync):
                num_replicas = max(1, min(self.mesh.size, 4))
                partition = None
                for r in range(num_replicas):
                    cand = self._initial_partition(
                        self._plain(current), ip_k, k, spans,
                        (ctx.seed * 31 + r * 7907) & 0x7FFFFFFF,
                    )
                    cut = self._host_cut(self._plain(current), cand)
                    if best_cut is None or cut < best_cut:
                        partition, best_cut = cand, cut
        if not skip_to_uncoarsen:
            part_ip, spans_ip = partition, spans
            ckpt.barrier(
                "dist-initial", level=len(levels), scheme="dist",
                payload=lambda: _dist_state_payload(part_ip, spans_ip),
                keep=[f"dist-level-{j}" for j in range(1, len(levels) + 1)],
                meta=self._dist_meta(num_levels=len(levels),
                                     current_k=int(ip_k)),
            )

        current_k = ip_k
        num_levels = (int(num_levels_meta) if num_levels_meta
                      else len(levels))
        start_level = (int(r_level) if r_stage == "dist-uncoarsen"
                       and r_level is not None else len(levels))
        with timer.scoped_timer("dist-uncoarsening", sync=sync):
            for level in range(start_level - 1, -1, -1):
                lvl = levels[level]
                dg = lvl.dg()
                fine_host = lvl.fine_host
                partition = partition[lvl.cmap]
                level_idx = num_levels - 1 - level
                seed = (ctx.seed * 92821 + level_idx) & 0x7FFFFFFF
                partition = self._refine_dist(
                    refiner, dg, fine_host, partition, current_k, spans,
                    seed, level)
                if deep:
                    from ..partitioning.deep import compute_k_for_n

                    target_k = min(k, compute_k_for_n(fine_host.n, ctx.shm))
                    while current_k < target_k:
                        partition, spans, current_k = self._extend_on_mesh(
                            fine_host, partition, spans)
                        partition = self._refine_dist(
                            refiner, dg, fine_host, partition, current_k,
                            spans, seed ^ (0x9E37 + current_k), level)
                part_now, spans_now, k_now = partition, spans, current_k
                ckpt.barrier(
                    "dist-uncoarsen", level=level, scheme="dist",
                    payload=lambda: _dist_state_payload(part_now, spans_now),
                    keep=[f"dist-level-{j}" for j in range(1, level + 1)],
                    meta=self._dist_meta(num_levels=num_levels,
                                         current_k=int(k_now)),
                )
        if deep and (levels or replicated or skip_to_uncoarsen) and (
                current_k < k):
            if levels:
                dg, fine_host = levels[0].dg(), levels[0].fine_host
            else:
                fine_host = self._plain(current)
                dg = self._dist_graph(fine_host)
            while current_k < k:
                partition, spans, current_k = self._extend_on_mesh(
                    fine_host, partition, spans)
                partition = self._refine_dist(
                    refiner, dg, fine_host, partition, current_k, spans,
                    (ctx.seed * 48947 + current_k) & 0x7FFFFFFF, 0)
        elif current_k < k:
            # no dist levels (a tiny graph): a full-k shm partition
            from ..kaminpar import KaMinPar

            shm = KaMinPar(ctx.shm.copy(), device=self.device)
            partition = shm.set_graph(self._plain(graph)).compute_partition(
                k=k, epsilon=ctx.partition.epsilon, seed=ctx.seed)
            current_k = k
        return partition

    # -- deep-mode helpers -------------------------------------------------

    def _initial_partition(self, host, ip_k, k, spans, seed) -> np.ndarray:
        """The coarsest graph's initial partitioner (factories.cc:72-88:
        KAMINPAR, RANDOM; MTKAHYPAR needs the external package)."""
        from .dist_context import DistInitialPartitioningAlgorithm as Alg

        algo = getattr(self.ctx, "initial_partitioning", Alg.KAMINPAR)
        if algo == Alg.RANDOM:
            rng = np.random.RandomState(seed & 0x7FFFFFFF)
            return rng.randint(0, ip_k, host.n).astype(np.int32)
        if algo == Alg.MTKAHYPAR:
            raise RuntimeError(
                "initial_partitioning=mtkahypar requires the external "
                "'mtkahypar' package"
            )
        return self._shm_ip(host, ip_k, k, spans, seed)

    def _shm_ip(self, host, ip_k, k, spans, seed) -> np.ndarray:
        """One seeded shared-memory KaMinPar run with span-aware caps,
        quiet."""
        from ..kaminpar import KaMinPar
        from ..utils.logger import OutputLevel, output_level, set_output_level

        outer_level = output_level()
        try:
            shm = KaMinPar(self.ctx.shm.copy(), device=self.device)
            shm.set_output_level(OutputLevel.QUIET)
            shm.set_graph(host)
            p_ = self.ctx.partition
            ip_caps = np.array(
                [p_.total_max_block_weights(first, first + count)
                 for first, count in spans],
                dtype=np.int64,
            )
            return shm.compute_partition(
                k=ip_k, epsilon=self.ctx.partition.epsilon,
                max_block_weights=(None if ip_k == k else ip_caps),
                seed=seed,
            )
        finally:
            set_output_level(outer_level)

    def _replication_factor(self, n: int) -> int:
        from .replication import choose_replication_factor

        return choose_replication_factor(
            n, int(self.mesh.size),
            int(getattr(self.ctx, "replication_min_nodes_per_device", 0)),
        )

    def _contract_level(self, current, dg, labels):
        """(coarse, cmap) of one level, or None when the clustering
        converged."""
        c_ctx = self.ctx.coarsening
        if current.m <= MAX_FUSED_EDGE_SLOTS:
            fine_dev = device_graph_from_host(self._plain(current),
                                              self.device)
            lab_dev = torch.from_numpy(
                np.asarray(labels, dtype=np.int32)).to(self.device)
            lab_dev = lab_dev[: fine_dev.n_pad]
            if lab_dev.shape[0] < fine_dev.n_pad:
                lab_dev = torch.cat([lab_dev, torch.arange(
                    lab_dev.shape[0], fine_dev.n_pad, dtype=torch.int32,
                    device=self.device)])
            coarse_dev, c_n, _c_m = contract_clustering(fine_dev, lab_dev)
            if c_n >= (1.0 - c_ctx.convergence_threshold) * current.n:
                return None
            cmap = coarse_dev.cmap[: current.n].cpu().numpy()
            coarse = host_graph_from_device(coarse_dev.graph)
        else:
            coarse, cmap = dist_contract_clustering(
                dg, current.n, current.node_weight_array(), labels)
            if coarse.n >= (1.0 - c_ctx.convergence_threshold) * current.n:
                return None
        return coarse, cmap

    def _replicated_phase(self, split_host: HostGraph, k: int, clusterer,
                          threshold: int):
        """Coarsen G replicas of `split_host` as one block-diagonal union
        over the mesh, IP each replica, refine the replica hierarchies in
        lockstep, and return the best replica's partition at the split
        level: (partition i32[split_host.n] in [0, ip_k), ip_k)."""
        from ..partitioning.deep import compute_k_for_n
        from .dist_lp import dist_lp_refine, dist_singleton_postpasses
        from .replication import (
            best_replica_partition,
            replica_bounds_after_contraction,
            slice_replica,
            union_graph,
        )

        ctx = self.ctx
        c_ctx = ctx.coarsening
        n_split = split_host.n
        G = self._replication_factor(n_split)
        ip_k = max(2, min(k, compute_k_for_n(n_split, ctx.shm)))
        spans = self._initial_spans(ip_k, k)
        union = union_graph(split_host, G)
        bounds = [g * n_split for g in range(G + 1)]
        self._replication_info = {"G": G, "split_n": n_split, "ip_k": ip_k}

        u_levels = []
        current, cur_bounds = union, bounds
        while max(cur_bounds[g + 1] - cur_bounds[g]
                  for g in range(G)) > threshold:
            dg = self._dist_graph(current)
            n_rep = max(cur_bounds[g + 1] - cur_bounds[g] for g in range(G))
            mcw = max(1, c_ctx.max_cluster_weight(
                n_rep, ctx.partition.total_node_weight, ctx.partition))
            lvl_seed = (ctx.seed * 7919 + (9601 + len(u_levels)) * 31337
                        ) & 0x7FFFFFFF
            with comm_phase(f"replicated-coarsening-L{len(u_levels)}"):
                labels = clusterer(dg, min(mcw, WMAX), lvl_seed)
            labels = labels.cpu().numpy().copy()
            for g in range(G):
                lo, hi = cur_bounds[g], cur_bounds[g + 1]
                sub = slice_replica(current, lo, hi)
                sub_lab = labels[lo:hi] - lo
                labels[lo:hi] = lo + dist_singleton_postpasses(
                    sub, sub_lab, min(mcw, WMAX))
            contracted = self._contract_level(current, dg, labels)
            if contracted is None:
                break
            coarse, cmap = contracted
            u_levels.append((dg, cmap, current))
            cur_bounds = replica_bounds_after_contraction(cmap, cur_bounds)
            current = coarse

        union_part = np.zeros(current.n, dtype=np.int32)
        for g in range(G):
            lo, hi = cur_bounds[g], cur_bounds[g + 1]
            sub = slice_replica(current, lo, hi)
            cand = self._shm_ip(sub, ip_k, k, spans,
                                (ctx.seed * 31 + g * 7907) & 0x7FFFFFFF)
            union_part[lo:hi] = cand.astype(np.int32) + g * ip_k

        base_caps = self._span_caps(spans).cpu().numpy()
        k_u, union_caps, _ = segments.pad_k_bucket(
            G * ip_k, torch.from_numpy(np.tile(base_caps, G)))
        for level_idx, (dg, cmap, fine_host) in enumerate(
                reversed(u_levels)):
            union_part = union_part[cmap]
            full = np.zeros(dg.n_pad, dtype=np.int32)
            full[: fine_host.n] = union_part
            seed = (ctx.seed * 50411 + level_idx * 73) & 0x7FFFFFFF
            refined = dist_lp_refine(
                dg, torch.from_numpy(full), k_u, union_caps, seed,
                num_iterations=ctx.lp_num_iterations,
            )
            union_part = refined.cpu().numpy()[: fine_host.n]
        rep_of_node = np.repeat(np.arange(G), n_split)
        if not ((union_part >= rep_of_node * ip_k)
                & (union_part < (rep_of_node + 1) * ip_k)).all():
            raise AssertionError(
                "union refinement moved a node across replicas")

        part, g_best, cut = best_replica_partition(split_host, union_part,
                                                   G, ip_k)
        self._replication_info.update(
            {"levels": len(u_levels), "best_replica": g_best, "cut": cut})
        telemetry.event("replicated-coarsening", **self._replication_info)
        log(
            f"replicated coarsening: G={G} replicas x "
            f"{int(self.mesh.size) // G} devices, "
            f"{len(u_levels)} levels, best replica {g_best} cut {cut}"
        )
        return part.astype(np.int32), ip_k

    def _initial_spans(self, current_k: int, final_k: int):
        """Block spans (first final block, count) of the current blocks."""
        from ..partitioning.rb import split_k

        spans: List[Tuple[int, int]] = []

        def rec(first: int, count: int, blocks: int):
            if blocks == 1:
                spans.append((first, count))
                return
            b0 = blocks // 2 + (blocks & 1)
            k0, k1 = split_k(count)
            rec(first, k0, b0)
            rec(first + k0, k1, blocks - b0)

        rec(0, final_k, current_k)
        return spans

    def _span_caps(self, spans) -> torch.Tensor:
        p = self.ctx.partition
        caps = np.array(
            [p.total_max_block_weights(first, first + count)
             for first, count in spans],
            dtype=np.int64,
        )
        return torch.from_numpy(np.minimum(caps, WMAX)).to(
            WEIGHT_DTYPE).to(self.device)

    def _refine_dist(self, refiner, dg, fine_host, partition, current_k,
                     spans, seed, level) -> np.ndarray:
        from ..resilience import deadline as deadline_mod

        if deadline_mod.agreed_stop():
            return partition
        full = np.zeros(dg.n_pad, dtype=np.int32)
        full[: fine_host.n] = partition
        with comm_phase(f"refinement-L{level}-k{current_k}"):
            refined = refiner(dg, torch.from_numpy(full).to(self.device),
                              current_k, self._span_caps(spans), seed,
                              level=level)
        return refined.cpu().numpy()[: fine_host.n]

    def _extend_on_mesh(self, fine_host, partition, spans):
        """Double k by bipartitioning every multi-span block's induced
        subgraph on the host (large blocks through the shm deep
        partitioner's device bipartition); the caller refines on the
        mesh at the doubled k."""
        from ..graphs.host import extract_block_subgraphs
        from ..initial import InitialMultilevelBipartitioner
        from ..partitioning.deep import DeepMultilevelPartitioner
        from ..partitioning.rb import bipartition_max_block_weights, split_k

        fine_host = self._plain(fine_host)
        rng = np.random.default_rng(
            (self.ctx.seed * 63018038201 + len(spans)) & 0x7FFFFFFF)
        current_k = len(spans)
        ext = extract_block_subgraphs(fine_host,
                                      partition.astype(np.int64), current_k)
        bipartitioner = InitialMultilevelBipartitioner(
            self.ctx.shm.initial_partitioning)
        deep_helper = DeepMultilevelPartitioner(self.ctx.shm, self.device)
        device_threshold = (
            self.ctx.shm.partitioning.device_bipartition_threshold)
        new_part = np.zeros(fine_host.n, dtype=np.int32)
        new_spans: List[Tuple[int, int]] = []
        next_id = 0
        for b, (first, count) in enumerate(spans):
            mask = partition == b
            if count <= 1:
                new_part[mask] = next_id
                new_spans.append((first, count))
                next_id += 1
                continue
            sub = ext.subgraphs[b]
            max_w = bipartition_max_block_weights(
                self.ctx.shm, first, count, sub.total_node_weight)
            if sub.n >= device_threshold:
                bp = deep_helper._device_bipartition(sub, max_w, rng)
            else:
                bp = bipartitioner.bipartition(sub, max_w, rng)
            k0, k1 = split_k(count)
            new_part[mask] = np.where(bp[ext.node_mapping[mask]] == 0,
                                      next_id, next_id + 1)
            new_spans.append((first, k0))
            new_spans.append((first + k0, k1))
            next_id += 2
        return new_part, new_spans, len(new_spans)

    def _host_cut(self, graph: HostGraph, partition: np.ndarray) -> int:
        src = graph.edge_sources()
        ew = graph.edge_weight_array()
        return int(ew[partition[src] != partition[graph.adjncy]].sum() // 2)

    # -- dist resilience ---------------------------------------------------

    def _dist_meta(self, num_levels: int,
                   current_k: Optional[int] = None) -> dict:
        meta = {"shards": list(self._shard_fps),
                "num_levels": int(num_levels)}
        if current_k is not None:
            meta["current_k"] = int(current_k)
        return meta

    def _restore_dist_levels(self, graph, arrays):
        """The hierarchy from the ``dist-level-<i>`` snapshots (coarse
        host CSR + cmap each; the DistGraphs are rebuilt on demand).
        Returns (levels, coarsest)."""
        names = sorted((nm for nm in arrays if nm.startswith("dist-level-")),
                       key=lambda s: int(s.rsplit("-", 1)[1]))
        levels: List[_DistLevel] = []
        fine = graph
        for nm in names:
            a = arrays[nm]
            coarse = HostGraph(
                xadj=np.asarray(a["xadj"], dtype=np.int64),
                adjncy=np.asarray(a["adjncy"], dtype=np.int32),
                node_weights=np.asarray(a["node_w"]),
                edge_weights=(np.asarray(a["edge_w"]) if a["edge_w"].size
                              else None),
            )
            levels.append(_DistLevel(
                fine, np.asarray(a["cmap"], dtype=np.int32), None, self))
            fine = coarse
        return levels, fine

    def spill_cold_levels(self) -> int:
        """The memory governor's spiller hook: drop every level's sharded
        arrays (rebuilt on demand, identically) and the retained finest
        sharded graph of a compressed input.  Returns the bytes freed."""
        from .dist_graph import dist_graph_bytes

        freed = 0
        for lvl in self._levels or []:
            freed += lvl.spill()
        if self._fine_dg is not None:
            freed += dist_graph_bytes(self._fine_dg)
            self._fine_dg = None
        if freed:
            from ..resilience import memory as memory_mod

            memory_mod.note_spill(freed)
            telemetry.event("memory-spill", bytes=freed, kind="dist-levels")
        return freed


class _DistLevel:
    """One dist coarsening level: the fine host graph, the fine->coarse
    cmap and the sharded graph (a deterministic cache: spilled and resumed
    levels rebuild it on demand)."""

    __slots__ = ("fine_host", "cmap", "_dg", "_owner")

    def __init__(self, fine_host, cmap, dg, owner: dKaMinPar):
        self.fine_host = fine_host
        self.cmap = np.asarray(cmap, dtype=np.int32)
        self._dg = dg
        self._owner = owner

    def dg(self) -> DistGraph:
        if self._dg is None:
            from ..resilience import memory as memory_mod
            from .dist_graph import dist_graph_bytes

            mesh = self._owner.mesh
            if self._owner._is_compressed(self.fine_host):
                self._dg = dist_graph_from_compressed(self.fine_host, mesh)
            else:
                self._dg = dist_graph_from_host(self.fine_host, mesh)
            nbytes = dist_graph_bytes(self._dg)
            memory_mod.note_reload(nbytes)
            telemetry.event("memory-reload", bytes=nbytes,
                            kind="dist-level")
        return self._dg

    def spill(self) -> int:
        if self._dg is None:
            return 0
        from .dist_graph import dist_graph_bytes

        nbytes = dist_graph_bytes(self._dg)
        self._dg = None
        return nbytes


def _dist_level_payload(level_no: int, coarse: HostGraph, cmap,
                        fine_n: int) -> dict:
    return {
        f"dist-level-{int(level_no)}": {
            "xadj": np.asarray(coarse.xadj, dtype=np.int64),
            "adjncy": np.asarray(coarse.adjncy, dtype=np.int32),
            "node_w": np.asarray(coarse.node_weight_array()),
            "edge_w": np.asarray(coarse.edge_weight_array()),
            "cmap": np.asarray(cmap, dtype=np.int32),
            "dims": np.asarray([int(fine_n), int(coarse.n), int(coarse.m)],
                               dtype=np.int64),
        }
    }


def _dist_state_payload(partition, spans) -> dict:
    return {
        "state": {
            "partition": np.asarray(partition, dtype=np.int32),
            "spans": np.asarray([[int(f), int(c)] for f, c in spans],
                                dtype=np.int64),
        }
    }
