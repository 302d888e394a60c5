"""The whole-query engine on a mesh: every join an explicit shuffle,
broadcast or skew split (S18_MESH > 1, the default engine there).

Counterpart of `sigmod2018_tpu/parallel/dist_compiled.py`.  Base columns
are row-sharded over the mesh (parallel/mesh.py); a query's device work
runs in list-of-shards form (`_run_spmd`, the JAX package's `shard_map`
step), and the only data that crosses shards is what the collectives of
parallel/collectives.py move:

- intermediate results carry VALUES, not row ids: after a shuffle a
  shard's rows come from other shards, so the columns that later joins,
  filters and checksums read (known from the plan) ride each exchange
  as payload;
- each join's strategy is chosen statically, from shapes and catalog
  stats:
    * broadcast: the build side's padded rows over the whole mesh are at
      most `bcast_threshold`: it is all_gather'ed (keys, liveness and
      payloads) and the probe side moves nothing;
    * skew split: the catalog's MCV sketch (exact mode and max
      multiplicity per column) shows a hot key whose rows, routed to one
      shard, would hand it `skew_factor` x a shard's average share: the
      hot rows of an unfiltered base side are all_gather'ed to every
      shard (their count is statically bounded by that column's fmax),
      the other side's hot rows join in place, and the cold rows take
      the shuffle;
    * shuffle: both sides partition by key mod ndev and all_to_all (or
      the ring of ppermute hops, S18_EXCHANGE=ring), with send buffers
      of the sender's local length or of the learned exchange caps;
- per-shard join output sizes depend on the data: as in
  engine/compiled.py the host supplies size classes beforehand, here per
  SHARD (guessed as the planner's estimate x spec_margin / ndev, or
  learned), and the packed result
  [t_1..t_k, m_1..m_k, x_1..x_2j, count, sums..] carries the psum'd
  global totals t (the guard), the pmax'd per-shard totals m (the
  classes) and the pmax'd per-destination send maxima x of each join's
  two sides (the learned caps, 0 where the join did not shuffle).
  `DistSpecResult` checks them after the batch's single fetch; a miss
  re-runs the query with one host read per intermediate join.

Learned values persist as one list per text, [k, classes.., xcaps..],
in a learned file of its own per mesh size (`-mesh{n}`).  An observed
send maximum of 0 is kept as the cap 0, "the sender's full length", so
that a join whose strategy later changes to the shuffle is never
truncated to a tiny cap.  The packed send maxima come per join as
(build side, probe side), as in the JAX package, but the caps are
learned per side of the join predicate (left, right): the build side is
the narrower one, and the width of a component is its size class, so a
learned class can swap a join's build and probe sides, where caps kept
per build and probe slot would each land on the other side and miss.  As in engine/compiled.py, and unlike the JAX
package, only the maxima of a line that holds are learned, and no
per-shard class passes size_class(total_limit): a blow-up is never sized
from what an earlier run of its text saw.

The factorized tier serves first, as in the JAX package, on whole
columns on the mesh's first device (`device_column`); so do the
blow-up net's message passing and the operator engine that serves a
query needing a cartesian product.  The text-order net runs on the mesh.

`join_strategies` and `comm_model` record each join's strategy and its
modeled bytes between shards (`note_comm`) the first time a plan runs:
the JAX package appends them when it traces a program, once per
(skeleton, join order, classes, columns, caps).

Under a process group (parallel/multihost.py) every rank runs this
engine on the same protocol and owns the shards `Mesh.local` lists;
each shard loop runs over those, and the collectives cross processes.
The ranks must issue the same collectives in the same order, so every
branch the host takes reads a replicated value (a psum, pmax or
all_gather result, or the static shapes and catalog stats every rank
shares), and the learned values agree: rank 0's learned file is
broadcast when the engine starts, every rank learns the same replicated
maxima, and only rank 0 writes the file.  The sharded columns come from
the host, each rank copying only its own shards' blocks to its devices;
a whole column goes to the first device only when the factorized tier
or the operator engine asks for it.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, List, Optional, Tuple

import torch

from .. import ops
from ..config import EngineConfig
from ..engine import factorized
from ..engine.compiled import CompiledTorchEngine, SpecResult, _Fallback
from ..engine.executor import (HARD_INTERMEDIATE_CAP, IntermediateBlowup,
                               NullResult, PendingResult, Result)
from ..frontend.parser import FilterPred, Query
from ..ops.u64 import MASK64, as_i64
from ..planner.join_order import estimate_cardinalities
from ..storage.catalog import Catalog
from ..utils.padding import size_class
from .collectives import all_gather, pmax, psum
from .dist import (_PAD_KEY, _stable_argsort, _stack, exchange_multi,
                   local_join_checksum_multi, partition_multi,
                   send_hist_max)
from .dist_engine import mesh_column, mesh_for, padded_column
from .mesh import Mesh, split_rows


class DistSpecResult(SpecResult):
    """A mesh query's packed vector [t_1..t_k, m_1..m_k, x_1..x_nx,
    count, sums..]: t the global totals of the intermediate joins (held
    against `limit`), m their per-shard maxima (held against the
    classes), x the per-destination send maxima (held against the
    exchange caps, a cap of 0 meaning the sender's full length).  x
    comes per join as (build, probe), the caps as (left, right), and
    `build_left` says which side of each join built.  A line that holds
    is learned (`record(m, x by side)`) and counted (`served`); one that
    does not is answered by `retry`."""

    def __init__(self, packed: torch.Tensor, num_views: int,
                 classes: Tuple[int, ...], limit: int, retry, record,
                 served, xcaps: Tuple[int, ...] = (),
                 build_left: Tuple[bool, ...] = ()):
        super().__init__(packed, num_views, classes, limit, retry, record,
                         served)
        self.xcaps = xcaps
        self.build_left = build_left

    def line_from(self, values) -> str:
        k, nx = len(self.classes), len(self.xcaps)
        totals = [int(t) for t in values[:k]]
        lmax = tuple(int(m) for m in values[k:2 * k])
        xmax = by_side([int(x) for x in values[2 * k:2 * k + nx]],
                       self.build_left)
        if (any(m > c for m, c in zip(lmax, self.classes))
                or any(c > 0 and x > c for x, c in zip(xmax, self.xcaps))
                or max(totals, default=0) > self.limit):
            return self.retry()
        self.record(lmax, xmax)
        self.served()
        return PendingResult.line_from(self, values[2 * k + nx:])


def by_side(pairs, build_left) -> Tuple[int, ...]:
    """Per-join (build, probe) pairs as (left, right): swapped where the
    right side built.  The mapping is its own inverse."""
    out = list(pairs)
    for i, left in enumerate(build_left):
        if not left:
            out[2 * i], out[2 * i + 1] = out[2 * i + 1], out[2 * i]
    return tuple(out)


def _skeleton(query: Query) -> tuple:
    """The query with each filter constant replaced by its index: the
    JAX package's program key, under which a plan's strategies are
    recorded once."""
    preds, i = [], 0
    for p in query.predicates:
        if isinstance(p, FilterPred):
            preds.append((p.binding, p.column, p.op, i))
            i += 1
        else:
            preds.append(p)
    return query.relations, tuple(preds), query.views


class DistCompiledTorchEngine(CompiledTorchEngine):
    """CompiledTorchEngine over a mesh: row-sharded columns and explicit
    shuffle, broadcast or skew-split joins (S18_MESH > 1)."""

    prep_join_artifacts = False

    def __init__(self, catalog: Catalog, config: EngineConfig,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh_for(config, mesh)  # the learned file's name
        super().__init__(catalog, config)
        self.device = self.mesh.local_devices[0]
        self._sharded: Dict[Tuple[int, int], tuple] = {}
        self._recorded: set = set()
        self._record_lock = threading.Lock()
        # each join's strategy and modeled traffic, per plan run first
        self.join_strategies: List[str] = []
        self.comm_model: List[dict] = []

    def _learned_file(self) -> Optional[str]:
        """Per-shard classes hold for one mesh size only."""
        fp = super()._learned_file()
        if fp is None:
            return None
        return fp.replace(".json", f"-mesh{self.mesh.size}.json")

    def _learned_cache(self) -> Dict[str, Tuple[int, ...]]:
        """The persisted values; under a process group rank 0's, sent to
        every rank, so that every rank sizes every query alike."""
        if self.mesh.world == 1:
            return super()._learned_cache()
        import torch.distributed as dist

        box = [super()._learned_cache() if self.mesh.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _persist_learned(self) -> None:
        """Rank 0 writes the learned file; the others hold the same
        values."""
        if self.mesh.rank == 0:
            super()._persist_learned()

    # ---- storage ---------------------------------------------------------

    def device_column(self, rid: int, cid: int) -> Tuple[torch.Tensor, int]:
        """The whole base column on the first device, padded to split
        into equal shards (in one process its blocks are the shards)."""
        return self._once(self._columns, (rid, cid),
                          lambda: mesh_column(self, rid, cid))

    def sharded_column(self, rid: int, cid: int):
        """(the blocks of this process's shards of the padded column, live
        rows): shard s owns rows [sL, (s+1)L).  In one process they are
        views of device_column; under a process group they are copied
        from the host, block by block."""
        def build():
            if self.mesh.world == 1:
                col, n = self.device_column(rid, cid)
            else:
                col, n = padded_column(self.catalog, rid, cid,
                                       self.mesh.size)
            return split_rows(col, self.mesh), n

        return self._once(self._sharded, (rid, cid), build)

    def prefetch(self) -> None:
        """The sharded columns; in one process after the base prefetch
        (whole columns, whose blocks the shards are, and the warm
        replay), under a group before the warm replay alone."""
        if self.mesh.world == 1:
            super().prefetch()
        for rid, rel in enumerate(self.catalog.relations):
            for cid in range(rel.num_columns):
                self.sharded_column(rid, cid)
        if self.mesh.world > 1 and self.config.warm_replay:
            self._replay_learned()

    # ---- learned classes and exchange caps -------------------------------

    def _learn_dist(self, text: str, classes: Tuple[int, ...],
                    xcaps: Tuple[int, ...]) -> None:
        self._learn(text, (len(classes),) + tuple(classes) + tuple(xcaps))

    def _learned_dist(self, query: Query, n_classes: int, nx: int):
        """(classes, exchange caps) learned for the text, or (None, ())
        when there are none of this plan's shape or a class passes the
        guard's class."""
        v = self._learned_classes.get(query.text)
        if not v or v[0] != n_classes or len(v) != 1 + n_classes + nx:
            return None, ()
        classes = tuple(v[1:1 + n_classes])
        if classes and max(classes) > self._class_cap:
            return None, ()
        return classes, tuple(v[1 + n_classes:])

    def _guess_classes(self, query: Query, joins,
                       class_idx: Tuple[int, ...]
                       ) -> Optional[Tuple[int, ...]]:
        """Per-shard classes: the estimate x spec_margin over the mesh
        (a hash-partitioned output lands about evenly; a skewed miss is
        caught by the pmax check and retried)."""
        ndev = self.mesh.size
        ests = estimate_cardinalities(query, self.catalog, joins)
        classes = []
        for idx in class_idx:
            est = max(int(ests[idx]), 1) * self.config.spec_margin
            cls = min(size_class(max(est // ndev, 1)), self._class_cap)
            if cls > self.config.spec_max:
                return None
            classes.append(cls)
        return tuple(classes)

    # ---- execution -------------------------------------------------------

    def _execute_compiled(self, query: Query, use_planner: bool = True,
                          guard: bool = True) -> Result:
        joins, cols_used, n_classes, class_idx = self._static_plan(
            query, use_planner)
        cols = {rc: self.sharded_column(*rc) for rc in cols_used}
        nx = 2 * len(joins)
        if n_classes and guard and self.config.speculate:
            learned, xcaps = self._learned_dist(query, n_classes, nx)
            classes = (learned if learned is not None
                       else self._guess_classes(query, joins, class_idx))
            if classes is not None:
                built_left = [True] * len(joins)
                out = self._run_spmd(query, joins, classes, cols_used, cols,
                                     xcaps, built_left)
                self._count("learned" if learned is not None else "guessed")

                def record(lmax, xmax) -> None:
                    self._learn_dist(
                        query.text, tuple(size_class(max(m, 1))
                                          for m in lmax),
                        tuple(size_class(x) if x else 0 for x in xmax))

                return DistSpecResult(
                    out, len(query.views), classes, self._limit,
                    self._make_dist_retry(query, joins, cols_used, cols,
                                          n_classes),
                    record, lambda: self._served("materialized", None),
                    xcaps=xcaps or (0,) * nx, build_left=tuple(built_left))
        self._count("incremental" if n_classes else "no_class")
        return self._run_incremental_spmd(query, joins, cols_used, cols,
                                          n_classes, guard)

    def _make_dist_retry(self, query: Query, joins, cols_used, cols,
                         n_classes: int):
        def retry() -> str:
            self._count("retried")
            try:
                res = self._run_incremental_spmd(query, joins, cols_used,
                                                 cols, n_classes, True)
            except IntermediateBlowup:
                res = self._blowup_net(query)
            if isinstance(res, NullResult):
                # an intermediate join came out empty, so nothing was
                # learned: values that missed would miss on every run
                self._forget(query.text)
                self._served("materialized", res)
            return res.line()

        return retry

    def _run_incremental_spmd(self, query: Query, joins, cols_used, cols,
                              n_classes: int, guard: bool) -> Result:
        """One host read of [global total, per-shard maximum] per
        intermediate join; the classes found teach the next run of the
        text (with full exchange caps: the next speculative run learns
        the real send maxima)."""
        nx = 2 * len(joins)
        tier = "materialized" if guard else "text_order"
        classes: Tuple[int, ...] = ()
        while True:
            out = self._run_spmd(query, joins, classes, cols_used, cols, ())
            if len(classes) == n_classes:
                if classes and guard:
                    self._learn_dist(query.text, classes, (0,) * nx)
                return DistSpecResult(
                    out, len(query.views), classes, HARD_INTERMEDIATE_CAP,
                    retry=lambda: "", record=lambda lmax, xmax: None,
                    served=lambda: self._served(tier, None),
                    xcaps=(0,) * nx)
            total, lmax = out.tolist()
            self._count("segment_reads")
            if total == 0:
                return NullResult(len(query.views))
            if (guard and 0 < self.config.max_intermediate < total) or (
                    total > HARD_INTERMEDIATE_CAP):
                raise IntermediateBlowup(total)
            classes = classes + (size_class(max(lmax, 1)),)

    def _blowup_net(self, query: Query) -> Result:
        """A forest query by message passing on whole columns; otherwise
        the text order on the mesh, its guard off (the technical cap
        still holds)."""
        res = factorized.factorized_result(self, query)
        if res is not None:
            return self._served("factorized_blowup", res)
        try:
            res = self._execute_compiled(query, use_planner=False,
                                         guard=False)
        except _Fallback:
            return self._served("text_order", self._execute(
                query, use_planner=False, guard=False))
        if isinstance(res, SpecResult):
            return res  # its tier is counted when its line is made
        return self._served("text_order", res)

    # ---- the SPMD step ---------------------------------------------------

    def _first_run(self, key) -> bool:
        with self._record_lock:
            if key in self._recorded:
                return False
            self._recorded.add(key)
            return True

    def _run_spmd(self, query: Query, joins, classes: Tuple[int, ...],
                  cols_used, cols, xcaps: Tuple[int, ...] = (),
                  built_left: Optional[list] = None) -> torch.Tensor:
        """The query's device work over the mesh, with the per-shard
        classes of its first len(classes) intermediate joins given and
        the exchange caps of each join's (left, right) sides (none: the
        senders' full lengths); `built_left[i]` is set to whether join i
        built on its left side.
        Returns [global total, per-shard maximum] of the next
        intermediate join when the classes run out before the end, else
        the packed vector of DistSpecResult (on the first device)."""
        mesh = self.mesh
        ndev = mesh.size
        local = mesh.local
        nloc = len(local)
        dev0 = self.device
        ns = tuple(cols[rc][1] for rc in cols_used)
        record = self._first_run((_skeleton(query), tuple(joins), classes,
                                  tuple(cols_used), ns, xcaps))
        cfg = self.config
        stats = self.catalog.stats

        def note_comm(idx: int, strategy: str, **kw) -> None:
            """Modeled bytes between shards for one join, from static
            shapes.  Shuffle: both sides' [ndev, cap] send buffers (a key
            and the payload u64 columns) but the diagonal.  Broadcast:
            the build side (keys, liveness bytes, payloads) to every
            other shard; the probe side moves nothing.  Skew: the cold
            shuffle plus the gather of [hot_cap] hot rows per shard; hot
            rows of the other side move nothing.  The ring moves the
            same bytes over other links."""
            if not record:
                return
            per_side = lambda cap, npay: (ndev * (ndev - 1) * cap
                                          * 8 * (1 + npay))
            if strategy == "shuffle":
                bytes_ici = (per_side(kw["cap_b"], kw["npay_b"])
                             + per_side(kw["cap_p"], kw["npay_p"]))
            elif strategy == "skew":
                hc = kw["hot_cap"]
                bytes_ici = (per_side(kw["cap_b"], kw["npay_b"])
                             + per_side(kw["cap_p"], kw["npay_p"])
                             + ndev * (ndev - 1)
                             * (hc * 8 * (1 + kw["npay_b"]) + hc))
            else:
                L = kw["L_b"]
                bytes_ici = (ndev * (ndev - 1)
                             * (L * 8 * (1 + kw["npay_b"]) + L))
            self.comm_model.append(dict(join=idx, strategy=strategy,
                                        bytes_ici=int(bytes_ici), **kw))
            if cfg.explain:
                print(f"--   comm join{idx}: {strategy} "
                      f"bytes_ici={bytes_ici} {kw}", file=sys.stderr)

        def note_strategy(strategy: str) -> None:
            if record:
                self.join_strategies.append(strategy)

        def skew_static(bb, bc, pbb, pbc, base_b, base_p, L_b, L_p):
            """(hot key values, per-shard gather cap, gather the build
            side?) for a join whose MCV sketch flags a hot key on an
            unfiltered base side, else None.  A key is hot when routing
            all its rows to one shard hands it skew_factor x the column's
            average per-shard share (fmax * ndev >= skew_factor * f).
            The gathered side is an unfiltered base column, whose fmax
            bounds its hot rows per shard, so nothing can truncate: the
            build side, or the probe side when the build side is a
            component."""
            if not cfg.skew_factor or not stats or not (base_b or base_p):
                return None

            def side_hot(binding, col, is_base):
                if not is_base:
                    return None
                st = stats[query.relations[binding]][col]
                fmax, f = int(st.fmax), max(int(st.f), 1)
                if fmax > 1 and fmax * ndev >= cfg.skew_factor * f:
                    return int(st.mode)
                return None

            hot = []
            for b_, c_, isb in ((bb, bc, base_b), (pbb, pbc, base_p)):
                hv = side_hot(b_, c_, isb)
                if hv is not None and hv != MASK64 and hv not in hot:
                    hot.append(hv)
            if not hot:
                return None
            gb, gc, L_g = (bb, bc, L_b) if base_b else (pbb, pbc, L_p)
            st_g = stats[query.relations[gb]][gc]
            hot_cap = min(L_g, size_class(len(hot) * max(int(st_g.fmax), 1)))
            return tuple(hot), hot_cap, base_b

        # Downstream needs: needs_after[i] = the columns joins[i:] and
        # the views read; a filter-phase component also carries every
        # filter and self-join column of its binding.
        view_cols = {(b, c) for b, c in query.views}
        needs_after: List[set] = [set(view_cols)
                                  for _ in range(len(joins) + 1)]
        for i in range(len(joins) - 1, -1, -1):
            s = set(needs_after[i + 1])
            s.add((joins[i].binding1, joins[i].column1))
            s.add((joins[i].binding2, joins[i].column2))
            needs_after[i] = s
        fs_cols = set()
        for p in query.filters_and_selfjoins:
            if isinstance(p, FilterPred):
                fs_cols.add((p.binding, p.column))
            else:
                fs_cols.add((p.binding1, p.column1))
                fs_cols.add((p.binding1, p.column2))
        filter_phase_needs = needs_after[0] | fs_cols

        totals: List[torch.Tensor] = []
        lmaxes: List[torch.Tensor] = []
        zero = torch.zeros((), dtype=torch.int64, device=dev0)
        xmaxes: List[torch.Tensor] = [zero] * (2 * len(joins))

        def done(packed: torch.Tensor) -> torch.Tensor:
            parts = []
            if totals:
                parts += [torch.stack(totals), torch.stack(lmaxes)]
            if xmaxes:
                parts.append(torch.stack(xmaxes))
            return torch.cat(parts + [packed])

        def base_col(b: int, c: int):
            """The shards of a base column and each shard's live rows."""
            shards, n = cols[(query.relations[b], c)]
            L = shards[0].shape[0]
            return shards, [min(max(n - s * L, 0), L) for s in local]

        def arange_live(width: int, counts):
            return [torch.arange(width, device=d) < n
                    for d, n in zip(self.mesh.local_devices, counts)]

        # component: (bindings, {(b, c): per-shard values}, per-shard counts)
        components: List[tuple] = []

        def find(b):
            for comp in components:
                if b in comp[0]:
                    return comp
            return None

        def new_base_component(b, res) -> None:
            pos = [r[0] for r in res]
            vals = {rc: [col.index_select(0, p) for col, p in
                         zip(base_col(*rc)[0], pos)]
                    for rc in sorted(filter_phase_needs) if rc[0] == b}
            components.append(((b,), vals, [r[1] for r in res]))

        def compact(comp, masks) -> None:
            width = (next(iter(comp[1].values()))[0].shape[0] if comp[1]
                     else masks[0].shape[0])
            res = [ops.mask_positions(m, out_size=width) for m in masks]
            vals = {rc: [x.index_select(0, r[0]) for x, r in zip(v, res)]
                    for rc, v in comp[1].items()}
            new = (comp[0], vals, [r[1] for r in res])
            components[:] = [new if c is comp else c for c in components]

        # ---- filters and self-joins (shard-local) --------------------
        for pred in query.filters_and_selfjoins:
            if isinstance(pred, FilterPred):
                comp = find(pred.binding)
                if comp is None:
                    col, live_n = base_col(pred.binding, pred.column)
                    new_base_component(pred.binding, [ops.mask_positions(
                        ops.compare_mask(x, n, pred.op, pred.value),
                        out_size=x.shape[0]) for x, n in zip(col, live_n)])
                else:
                    vals = comp[1][(pred.binding, pred.column)]
                    compact(comp, [ops.compare_mask(v, n, pred.op,
                                                    pred.value)
                                   for v, n in zip(vals, comp[2])])
            else:
                comp = find(pred.binding1)
                if comp is None:
                    c1, live_n = base_col(pred.binding1, pred.column1)
                    c2, _ = base_col(pred.binding1, pred.column2)
                    new_base_component(pred.binding1, [ops.mask_positions(
                        ops.equal_mask(a, b, n), out_size=a.shape[0])
                        for a, b, n in zip(c1, c2, live_n)])
                else:
                    v1 = comp[1][(pred.binding1, pred.column1)]
                    v2 = comp[1][(pred.binding1, pred.column2)]
                    compact(comp, [ops.equal_mask(a, b, n)
                                   for a, b, n in zip(v1, v2, comp[2])])

        def side_arrays(comp, b, key_c, payload_rcs):
            """Per shard: keys, live mask (a prefix: filters and
            exchanges compact), payload tuple."""
            if comp is None:
                keys, live_n = base_col(b, key_c)
                pays = [base_col(*rc)[0] for rc in payload_rcs]
            else:
                keys, live_n = comp[1][(b, key_c)], comp[2]
                pays = [comp[1][rc] for rc in payload_rcs]
            live = arange_live(keys[0].shape[0], live_n)
            return keys, live, [tuple(p[s] for p in pays)
                                for s in range(nloc)]

        def gather_rows(keys, live, pays):
            """all_gather of every shard's (keys, liveness, payloads),
            the live rows stably compacted to a prefix per shard: the
            liveness rides along, so a live 2^64-1 key stays live."""
            gk, gl = all_gather(mesh, keys), all_gather(mesh, live)
            npay = len(pays[0])
            gp = [all_gather(mesh, [p[i] for p in pays])
                  for i in range(npay)]
            out = []
            for s in range(nloc):
                k, lv = gk[s].reshape(-1), gl[s].reshape(-1)
                order = _stable_argsort(~lv)
                out.append((torch.where(lv[order], k[order], _PAD_KEY),
                            tuple(g[s].reshape(-1)[order] for g in gp),
                            lv.sum()))
            return out

        def shuffle(keys, live, pays, cap: int):
            parts = [partition_multi(k, p, lv, ndev, cap)
                     for k, lv, p in zip(keys, live, pays)]
            return exchange_multi(mesh, [p[0] for p in parts],
                                  [p[1] for p in parts],
                                  [p[2] for p in parts], via=cfg.exchange)

        def send_max(keys, live) -> torch.Tensor:
            return pmax(mesh, [send_hist_max(k, lv, ndev)
                               for k, lv in zip(keys, live)])[0]

        # ---- joins ---------------------------------------------------
        class_i = 0
        view_b = {b for b, _ in query.views}
        for idx, jp in enumerate(joins):
            comp_l = find(jp.binding1)
            comp_r = find(jp.binding2)
            if comp_l is not None and comp_l is comp_r:
                v1 = comp_l[1][(jp.binding1, jp.column1)]
                v2 = comp_l[1][(jp.binding2, jp.column2)]
                compact(comp_l, [ops.equal_mask(a, b, n)
                                 for a, b, n in zip(v1, v2, comp_l[2])])
                continue

            bind_l = comp_l[0] if comp_l is not None else (jp.binding1,)
            bind_r = comp_r[0] if comp_r is not None else (jp.binding2,)
            after = needs_after[idx + 1]
            pay_l = sorted(rc for rc in after if rc[0] in bind_l)
            pay_r = sorted(rc for rc in after if rc[0] in bind_r)

            last = idx == len(joins) - 1
            merged = set(bind_l) | set(bind_r)
            others = [c for c in components
                      if c is not comp_l and c is not comp_r]
            fused = last and not others and view_b <= merged

            kl, livel, pl_ = side_arrays(comp_l, jp.binding1, jp.column1,
                                         pay_l)
            kr, liver, pr_ = side_arrays(comp_r, jp.binding2, jp.column2,
                                         pay_r)
            build_left = kl[0].shape[0] <= kr[0].shape[0]
            kb, liveb, pb = (kl, livel, pl_) if build_left else (kr, liver,
                                                                 pr_)
            kp, livep, pp = (kr, liver, pr_) if build_left else (kl, livel,
                                                                 pl_)
            pay_b, pay_p = (pay_l, pay_r) if build_left else (pay_r, pay_l)
            bset = set(bind_l) if build_left else set(bind_r)
            bb_, bc_ = ((jp.binding1, jp.column1) if build_left
                        else (jp.binding2, jp.column2))
            pbb_, pbc_ = ((jp.binding2, jp.column2) if build_left
                          else (jp.binding1, jp.column1))
            comp_b = comp_l if build_left else comp_r
            comp_p = comp_r if build_left else comp_l
            L_b, L_p = kb[0].shape[0], kp[0].shape[0]
            skew_info = skew_static(bb_, bc_, pbb_, pbc_, comp_b is None,
                                    comp_p is None, L_b, L_p)
            if built_left is not None:
                built_left[idx] = build_left
            cap_b, cap_p = (by_side(xcaps[2 * idx:2 * idx + 2],
                                    (build_left,)) if xcaps else (0, 0))
            cap_b = min(cap_b, L_b) or L_b
            cap_p = min(cap_p, L_p) or L_p

            if L_b * ndev <= cfg.bcast_threshold:
                note_strategy("broadcast")
                note_comm(idx, "broadcast", L_b=L_b, npay_b=len(pay_b))
                got = gather_rows(kb, liveb, pb)
                rkb, rpb, nb = ([g[i] for g in got] for i in range(3))
                rkp = [torch.where(lv, k, _PAD_KEY)
                       for k, lv in zip(kp, livep)]
                rpp = pp
                npr = [lv.sum() for lv in livep]
            elif skew_info is not None:
                note_strategy("skew")
                hot_vals, hot_cap, gather_build = skew_info
                note_comm(idx, "skew", cap_b=cap_b, cap_p=cap_p,
                          hot_cap=hot_cap, hot_keys=len(hot_vals),
                          gather="build" if gather_build else "probe",
                          npay_b=len(pay_b), npay_p=len(pay_p))

                def is_hot(keys, live):
                    out = []
                    for k, lv in zip(keys, live):
                        m = k == as_i64(hot_vals[0])
                        for hv in hot_vals[1:]:
                            m = m | (k == as_i64(hv))
                        out.append(m & lv)
                    return out

                hot_b, hot_p = is_hot(kb, liveb), is_hot(kp, livep)
                cold_b = [lv & ~h for lv, h in zip(liveb, hot_b)]
                cold_p = [lv & ~h for lv, h in zip(livep, hot_p)]
                # Hot rows of the gathered side go to every shard (at
                # most hot_cap per shard: nothing truncates).
                kg, pg, hot_g = ((kb, pb, hot_b) if gather_build
                                 else (kp, pp, hot_p))
                hk, hl, hpay = [], [], []
                for k, p, h in zip(kg, pg, hot_g):
                    sel_ord = _stable_argsort(~h)[:hot_cap]
                    sel = h[sel_ord]
                    hk.append(torch.where(sel, k[sel_ord], _PAD_KEY))
                    hl.append(sel)
                    hpay.append(tuple(torch.where(sel, x[sel_ord], 0)
                                      for x in p))
                gk, gl = all_gather(mesh, hk), all_gather(mesh, hl)
                gpay = [all_gather(mesh, [hp[i] for hp in hpay])
                        for i in range(len(hpay[0]))]
                # The cold rows take the shuffle (the learned caps and the
                # send maxima are theirs).
                xmaxes[2 * idx] = send_max(kb, cold_b)
                xmaxes[2 * idx + 1] = send_max(kp, cold_p)
                ck_b, cp_b, nb_c = shuffle(kb, cold_b, pb, cap_b)
                ck_p, cp_p, np_c = shuffle(kp, cold_p, pp, cap_p)

                # One local table per side: the exchanged cold rows, plus
                # the gathered hot rows or the hot rows in place.  A key
                # is hot on both sides or on neither, so cold and hot rows
                # cannot match; the live rows compact to a prefix.
                def cat_compact(k1, pays1, live1, k2, pays2, live2):
                    k = torch.cat([k1, k2])
                    live = torch.cat([live1, live2])
                    order = _stable_argsort(~live)
                    pays = tuple(torch.cat([a, b])[order]
                                 for a, b in zip(pays1, pays2))
                    return (torch.where(live[order], k[order], _PAD_KEY),
                            pays, live.sum())

                rkb, rpb, nb, rkp, rpp, npr = [], [], [], [], [], []
                for s in range(nloc):
                    lcb = (torch.arange(ck_b[s].shape[0],
                                        device=ck_b[s].device) < nb_c[s])
                    lcp = (torch.arange(ck_p[s].shape[0],
                                        device=ck_p[s].device) < np_c[s])
                    g = (gk[s].reshape(-1),
                         tuple(x[s].reshape(-1) for x in gpay),
                         gl[s].reshape(-1))
                    if gather_build:
                        b_ = cat_compact(ck_b[s], cp_b[s], lcb, *g)
                        p_ = cat_compact(ck_p[s], cp_p[s], lcp, kp[s],
                                         pp[s], hot_p[s])
                    else:
                        b_ = cat_compact(ck_b[s], cp_b[s], lcb, kb[s],
                                         pb[s], hot_b[s])
                        p_ = cat_compact(ck_p[s], cp_p[s], lcp, *g)
                    for lst, v in zip((rkb, rpb, nb, rkp, rpp, npr),
                                      b_ + p_):
                        lst.append(v)
            else:
                note_strategy("shuffle")
                note_comm(idx, "shuffle", cap_b=cap_b, cap_p=cap_p,
                          npay_b=len(pay_b), npay_p=len(pay_p))
                # Send buffers of the learned cap, else of the sender's
                # whole local length (always enough).  A cap the data
                # outgrew truncates; the packed send maxima show it and
                # the host retries with full caps.
                xmaxes[2 * idx] = send_max(kb, liveb)
                xmaxes[2 * idx + 1] = send_max(kp, livep)
                rkb, rpb, nb = shuffle(kb, liveb, pb, cap_b)
                rkp, rpp, npr = shuffle(kp, livep, pp, cap_p)

            if fused:
                # last join and checksums in one: each view's values on
                # its own side
                packed = []
                views_b = [v for v in query.views if v[0] in bset]
                views_p = [v for v in query.views if v[0] not in bset]
                for s in range(nloc):
                    bcols = [rpb[s][pay_b.index(v)] for v in views_b]
                    pcols = [rpp[s][pay_p.index(v)] for v in views_p]
                    count, sums_b, sums_p = local_join_checksum_multi(
                        rkb[s], _stack(bcols, rkb[s]), nb[s],
                        rkp[s], _stack(pcols, rkp[s]), npr[s])
                    it_b, it_p = iter(sums_b), iter(sums_p)
                    packed.append(torch.stack(
                        [count] + [next(it_b) if v[0] in bset
                                   else next(it_p) for v in query.views]))
                return done(psum(mesh, packed)[0])

            # ---- intermediate: shard-local sort-join and emit --------
            builds = [ops.join_build(k, n) for k, n in zip(rkb, nb)]
            counts = [ops.join_probe_count_auto(sk, n, k, m)
                      for (sk, _), n, k, m in zip(builds, nb, rkp, npr)]
            total_loc = [c[3] for c in counts]
            g_total = psum(mesh, total_loc)[0]
            l_max = pmax(mesh, total_loc)[0]
            if class_i >= len(classes):
                # segment boundary: the host reads (global, per-shard max)
                return torch.stack([g_total, l_max])
            totals.append(g_total)
            lmaxes.append(l_max)
            Pc = classes[class_i]
            class_i += 1
            vals: Dict[tuple, list] = {rc: [] for rc in pay_b + pay_p}
            cnt_new = []
            for s in range(nloc):
                perm = builds[s][1]
                lo, _, ccum, tot = counts[s]
                bpos, ppos = ops.join_emit(perm, lo, ccum, tot, out_size=Pc)
                for i, rc in enumerate(pay_b):
                    vals[rc].append(rpb[s][i].index_select(0, bpos))
                for i, rc in enumerate(pay_p):
                    vals[rc].append(rpp[s][i].index_select(0, ppos))
                cnt_new.append(torch.clamp(tot, max=Pc).to(torch.int32))
            components[:] = [c for c in components
                             if c is not comp_l and c is not comp_r]
            components.append((tuple(sorted(merged)), vals, cnt_new))

        # ---- checksums (no fused final join happened) ----------------
        comp = components[0]
        width = next(iter(comp[1].values()))[0].shape[0] if comp[1] else 0
        live = arange_live(width, comp[2])
        parts = [psum(mesh, [torch.as_tensor(n, device=d).to(torch.int64)
                             for n, d in zip(comp[2],
                                             mesh.local_devices)])[0]]
        for b, c in query.views:
            parts.append(psum(mesh, [torch.where(lv, v, 0).sum()
                                     for lv, v in
                                     zip(live, comp[1][(b, c)])])[0])
        return done(torch.stack(parts))

