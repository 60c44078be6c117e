"""High-level table API (port of the eager parts of ``repro.core.table``).

    table = DistributedHashTable(num_shards=8, hash_range=1 << 20)  # the card
    state = table.init(keys)                  # keys: (N,) uint32, N % 8 == 0
    wide = DistributedHashTable(num_shards=8, hash_range=1 << 20,
                                schema=TableSchema("uint64", 4))
    state64 = wide.init(keys64, values)       # (N,) uint64 or (N, 2) lanes; (N, 4) int32
    state = state.insert(new_keys)            # functional delta insert
    state = state.delete(dead_keys)           # tombstone delete
    state = state.upsert(kv_keys, kv_values, ttl=5)
    counts = table.query(state, queries)
    result = table.retrieve(state, queries)   # count-first capacity sizing
    pairs = join_to_pairs(table.inner_join(state, queries))
    plan = table.plan_retrieve(num_queries=n, out_capacity=4096, seg_capacity=512)
    compiled = plan.compile(state)            # bound to state's structure
    state = state.compact()                   # fold deltas + tombstones

By default the D shards live on one device (``exchange.StackedGroup``).
Results keep the reference's global layout: shard blocks stacked along dim
0, e.g. ``offsets`` of shape ``(D * (n_local + 1),)``, so they compare
directly with the JAX package's arrays.

With ``group=`` a ``torch.distributed`` process group (or
``exchange.ProcessGroup``), each rank holds one shard and the same calls
run on every rank, the reference's ``shard_map`` program:

    group = launch.mesh.init_shard_group()    # torchrun's RANK / WORLD_SIZE
    table = DistributedHashTable(hash_range=1 << 20, group=group)
    state = table.init(my_keys)               # this rank's block of the keys
    counts = table.query(state, my_queries)   # this rank's block of counts

Keys, values and queries are then the rank's own block (the same length on
every rank), results its block of the global layout (rank ``r``'s equal
row ``r`` of a stacked run), and scalars (``num_dropped``, ``join_size``,
``plan_caps``) global.  ``delete`` and ``upsert`` take the same replicated
batch on every rank, as the reference's ``P()`` in-spec does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import exchange, hashgraph, hashing, multi_hashgraph, partition, plans
from repro_torch.core.hashgraph import EMPTY_BITS
from repro_torch.core.multi_hashgraph import (
    DistributedHashGraph,
    ShardJoin,
    ShardRetrieval,
)
from repro_torch.core.plans import JoinPlan, QueryPlan, RetrievePlan
from repro_torch.core.schema import TableSchema
from repro_torch.core.state import TableState, as_state, empty_tombstones
from repro_torch.kernels import histogram
from repro_torch.utils import cdiv, take_rows

@dataclasses.dataclass(kw_only=True, eq=False)
class DistributedHashTable:
    """The distributed HashGraph of ``num_shards`` shards on one device, or
    of one shard per rank of ``group`` (``num_shards`` is then its size).

    ``device=None`` takes the CUDA card and raises when there is none; the
    plain PyTorch path runs only when the caller asks for ``device="cpu"``.
    Every other field keeps the reference's default and meaning:
    ``paper_faithful_probe`` counts queries by the paper's linear bucket scan
    (kernel 5) capped at ``max_probe`` words; ``max_deltas`` bounds the delta
    ring and ``tombstone_capacity`` the delete buffer; ``coherent_deltas``
    builds each insert on the base's frozen splits so one routing round
    serves the whole stack (``fused_routing=False`` forces per-layer
    routing anyway); ``skew_guard`` sends a batch that would overflow the
    frozen-splits dispatch to a delta of its own splits instead of dropping
    rows, counted in ``skew_fallbacks``.  ``schema`` sets the key width and
    value columns; ``fingerprint`` the probe fingerprint lane of every
    layer (``None``: on exactly for multi-lane keys).

    ``replicate_hot_keys`` (R > 1 enables) handles the skew no split can
    fix: one key whose copies in an insert batch exceed the per-(source,
    destination) dispatch slot.  A coherent insert spreads each such key's
    rows over ``max(2, min(R, D))`` consecutive owners and registers it in
    ``hot_keys``; ``query`` (and ``contains``) then sum one routed round
    per replica rank.  As in the reference, ``retrieve``, ``inner_join``
    and ``join_size`` see only replica 0, and ``compact()`` gathers the
    rows back onto their hash owner.  Over a process group the occurrence
    ranks are taken over the whole batch (rank 0's block, then rank 1's, ...):
    one ``all_gather`` of the batch's keys (counted with the reductions), so
    ``hot_keys`` and R come out the same on every rank and each rank's
    offsets are its row of the stacked run's.

    ``group``: ``None`` stacks ``num_shards`` shards on ``device``; a
    ``torch.distributed`` process group, ``"world"`` or an
    ``exchange.ProcessGroup`` puts one shard on each rank, on the rank's
    current CUDA device unless ``device`` says otherwise.
    """

    hash_range: int
    num_shards: int = 1
    device: Optional[object] = None
    seed: int = hashing.DEFAULT_SEED
    capacity_slack: float = 1.25
    range_slack: float = 1.5
    num_bins: Optional[int] = None
    paper_faithful_probe: bool = False
    max_probe: int = 64
    schema: Optional[TableSchema] = None
    max_deltas: int = 8
    tombstone_capacity: int = 1024
    coherent_deltas: bool = True
    fused_routing: Optional[bool] = None
    skew_guard: bool = True
    fingerprint: Optional[bool] = None
    replicate_hot_keys: int = 0
    group: object = None

    def __post_init__(self):
        if self.group is None:
            self.group = exchange.StackedGroup(max(1, self.num_shards))
        else:
            self.group = exchange.as_group(self.group)
            self.num_shards = self.group.size
        if self.device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DistributedHashTable runs on the CUDA card by default and "
                    "none is available; pass device='cpu' for the plain path"
                )
            self.device = torch.device("cuda", torch.cuda.current_device()) \
                if self.group.is_process else "cuda"
        self.device = torch.device(self.device)
        if self.schema is None:
            self.schema = TableSchema()
        # One probe layout for base, delta, fold and compact builds.
        if self.fingerprint is None:
            self.use_fingerprint = self.schema.key_lanes > 1
        else:
            self.use_fingerprint = bool(self.fingerprint)
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")
        hashing.check_table_size(self.hash_range)
        self.local_range_cap = int(cdiv(self.hash_range, self.num_shards) * self.range_slack)
        # Inserts the skew guard sent to a delta of its own splits.
        self.skew_fallbacks = 0
        # Hot-key registry: packed key tuple (lane values, lane 0 first) -> R.
        self.hot_keys = {}
        # Compact sizing per state signature: (capacity, rebuild_rows).
        self._sizing_memo = {}

    @property
    def num_devices(self) -> int:
        """The shard count (the reference's device count)."""
        return self.num_shards

    def _shard(self, flat: torch.Tensor, what: str) -> torch.Tensor:
        """A caller's batch as ``(local, n_local[, W])`` rows: the global
        batch cut into the shards, or over a process group this rank's block
        (checked to be as long on every rank: one ``agree``)."""
        n = flat.shape[0]
        if self.group.is_process:
            if not self.group.same([n]):
                raise ValueError(
                    f"{what}: ranks passed blocks of different lengths (this rank {n}); "
                    "every rank passes the same number of rows"
                )
            return flat.unsqueeze(0)
        if n % self.num_shards:
            raise ValueError(
                f"{what} length {n} is not divisible by num_shards={self.num_shards}"
            )
        return flat.reshape(self.num_shards, n // self.num_shards, *flat.shape[1:])

    def _shard_rows(self, flat: torch.Tensor, vals: torch.Tensor) -> tuple:
        """:meth:`_shard` of a key batch and its values together (one
        ``agree`` of both lengths over a process group)."""
        if not self.group.is_process:
            return self._shard(flat, "keys"), self._shard(vals, "values")
        n, m = flat.shape[0], vals.shape[0]
        if not self.group.same([n, m]) or n != m:
            raise ValueError(
                f"keys/values: ranks passed blocks of different lengths (this rank {n} keys, "
                f"{m} values); every rank passes the same number of rows"
            )
        return flat.unsqueeze(0), vals.unsqueeze(0)

    def _row_ids(self, n: int) -> torch.Tensor:
        """The default payload of a caller's ``n`` rows: their row ids in the
        global batch (over a process group, rank ``r``'s block starts at
        ``r * n``)."""
        ids = self.schema.default_values(n, self.device)
        offset = self.group.rank * n
        return ids + offset if offset else ids

    def _deal(self, flat: torch.Tensor) -> torch.Tensor:
        """The local rows of a replicated batch (length divisible by D) cut
        into the shards: every shard stacked, or this rank's block."""
        return self.group.rows(flat.reshape(self.num_shards, -1, *flat.shape[1:]))

    def _global_len(self, n_local_rows: int) -> int:
        """Global batch length of a caller's ``n_local_rows``-row batch (a
        stacked caller passes the global batch, a rank its block)."""
        return int(n_local_rows) * (self.num_shards // self.group.local)

    def _check_replicated(self, what: str, *batches) -> None:
        """Over a process group, raise ``ValueError`` on every rank unless
        every rank passed the same batches: one ``agree`` of each batch's
        length and 64-bit checksum."""
        if not self.group.is_process:
            return
        marks = []
        for b in batches:
            t = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(b))
            marks += [t.shape[0], exchange.checksum64(t)]
        if not self.group.same(marks):
            raise ValueError(
                f"{what}: the batch differs between ranks; {what} takes the same "
                "(replicated) batch on every rank"
            )

    def _pack_queries(self, queries) -> torch.Tensor:
        return self._shard(self.schema.pack_keys(queries, self.device), "queries")

    # -- build ----------------------------------------------------------------
    def _num_bins_for(self, hash_range: int) -> Optional[int]:
        # A pinned bin count is sized for the table's hash range; a narrowed
        # delta range takes the automatic choice.
        return self.num_bins if hash_range == self.hash_range else None

    def _build(self, keys, values, *, hash_range: int, num_bins, capacity=None, **kw):
        """Four-phase build of ``(D, n_local)`` keys with the table's settings."""
        return multi_hashgraph.build_sharded(
            keys,
            hash_range=hash_range,
            values=values,
            num_bins=num_bins,
            capacity_slack=self.capacity_slack,
            range_slack=self.range_slack,
            seed=self.seed,
            capacity=capacity,
            fingerprint=self.use_fingerprint,
            group=self.group,
            **kw,
        )

    def build(self, keys, values=None) -> DistributedHashGraph:
        """Build the distributed graph from a global ``(N,)`` key array
        (``(N,)`` uint64 or ``(N, 2)`` lanes for the uint64 schema).

        ``values``: optional ``(N,)`` / ``(N, C)`` int32 payload (default:
        global row ids, 1-column schemas only).
        """
        flat = self.schema.pack_keys(keys, self.device)
        if values is None:
            vals = self._row_ids(flat.shape[0])
        else:
            vals = self.schema.pack_values(values, self.device)
        k, v = self._shard_rows(flat, vals)
        return self._build(k, v, hash_range=self.hash_range, num_bins=self.num_bins)

    def init(self, keys, values=None) -> TableState:
        """Build and wrap into a :class:`TableState` with an empty delta ring
        and a zero-capacity tombstone buffer (it grows on the first delete)."""
        return TableState(
            base=self.build(keys, values),
            deltas=(),
            tombstones=empty_tombstones(0, device=self.device, key_lanes=self.schema.key_lanes),
            table=self,
        )

    # -- functional mutation ------------------------------------------------
    def _delta_hash_range(self, num_keys: int) -> int:
        """Hash range of an incoherent delta: sized to the batch."""
        return min(self.hash_range, max(256, 2 * num_keys))

    def _delta_bucket_geometry(self, num_keys: int) -> tuple[int, int]:
        """``(local_range_cap, bucket_stride)`` of a coherent delta: the base's
        bucket map strided down to O(batch) buckets."""
        target = max(128, cdiv(2 * num_keys, self.num_shards))
        stride = max(1, cdiv(self.local_range_cap, target))
        return cdiv(self.local_range_cap, stride), stride

    def _hot_key_offsets(self, flat: torch.Tensor) -> Optional[torch.Tensor]:
        """Hot-key detection: per-row destination offsets ``(N,)`` int32, or
        None when no key of the batch is hot.

        A key is hot when its copies in this batch exceed the per-(source,
        destination) dispatch slot of the coherent delta build, and it is
        not EMPTY.  Its rows get ``occurrence_rank % R`` (the rank in row
        order over the whole batch, R = ``max(2, min(replicate_hot_keys,
        D))``), every other row 0, and it is registered in ``hot_keys``.
        The ranks come from a stable sort of the keys on the device; only
        the verdict and the hot keys come to the host.
        """
        d, n = self.num_shards, flat.shape[0]
        if n == 0:
            return None
        lanes = self.schema.key_lanes
        slot = multi_hashgraph.default_capacity(n // d, d, self.capacity_slack)
        words, order = torch.sort(hashgraph.key_words(flat, lanes), stable=True)
        new_run = torch.ones(n, dtype=torch.bool, device=flat.device)
        new_run[1:] = words[1:] != words[:-1]
        run_start = torch.nonzero(new_run).squeeze(1)
        run_len = torch.diff(run_start, append=run_start.new_tensor([n]))
        hot = (run_len > slot) & (words[run_start] != EMPTY_BITS)
        if not bool(hot.any()):
            return None
        r = max(2, min(self.replicate_hot_keys, d))
        run_id = torch.cumsum(new_run, 0) - 1
        rank = torch.arange(n, device=flat.device) - run_start[run_id]
        sorted_offs = torch.where(hot[run_id], rank % r, 0).to(torch.int32)
        offsets = torch.empty_like(sorted_offs).scatter_(0, order, sorted_offs)
        for w in words[run_start[hot]].tolist():
            self.hot_keys[tuple((w >> (32 * i)) & 0xFFFFFFFF for i in range(lanes))] = r
        return offsets

    def _replica_offsets(self, k: torch.Tensor) -> Optional[torch.Tensor]:
        """:meth:`_hot_key_offsets` of ``(local, n_local[, L])`` key rows:
        the local rows' ``(local, n_local)`` offsets, ranked over every
        shard's rows (stacked already; one ``all_gather`` over a process
        group), or None when no key of the batch is hot."""
        whole = self.group.all_gather(k)
        offsets = self._hot_key_offsets(whole.reshape(-1, *k.shape[2:]))
        return None if offsets is None else self._deal(offsets)

    def _coherent_dispatch_overflows(
        self, keys: torch.Tensor, splits: torch.Tensor, offsets: Optional[torch.Tensor] = None
    ) -> bool:
        """Would a frozen-splits delta build of ``(local, n_local)`` keys
        overflow a per-(source, destination) dispatch slot?  Replays the
        build's routing (the hot-key ``offsets`` ``(local, n_local)`` added,
        EMPTY rows round-robin) and histograms the local sources' pairs on
        the device; only the verdict comes to the host, agreed by MAX over
        the group."""
        d, n_local = self.num_shards, keys.shape[1]
        lanes = self.schema.key_lanes
        capacity = multi_hashgraph.default_capacity(n_local, d, self.capacity_slack)
        h = hashing.hash_to_buckets(keys, self.hash_range, self.seed, lanes)
        dest = partition.destination_of(h, splits)
        if offsets is not None:
            dest = (dest + offsets) % d
        round_robin = torch.arange(n_local, dtype=torch.int32, device=keys.device) % d
        dest = torch.where(hashgraph.is_empty_key(keys, lanes), round_robin, dest)
        src = self.group.ranks(keys.device).unsqueeze(1)
        per_pair = histogram.bin_histogram((src * d + dest).to(torch.int32), d * d)
        over = bool((per_pair > capacity).any())
        return bool(self.group.agree([int(over)])[0])

    def insert(self, state, keys, values=None, *, auto_compact: bool = False) -> TableState:
        """Functional insert: a new state with one more delta graph.

        ``keys``/``values`` follow :meth:`build` (``N % num_shards == 0``;
        over a process group this rank's block); ``values=None`` gives the
        row id within the batch.  Raises when the
        ring is full unless ``auto_compact`` compacts first (whenever
        :meth:`TableState.should_compact` fires).  With ``coherent_deltas``
        the delta is built on the base's frozen splits; a batch that would
        overflow that dispatch goes to a delta of its own splits instead
        (``skew_guard``, counted in ``skew_fallbacks``), after hot keys
        (``replicate_hot_keys``) were spread over their replica owners.
        """
        st = as_state(self, state)
        if auto_compact and st.should_compact():
            st = self.compact(st)
        flat = self.schema.pack_keys(keys, self.device)
        if values is None:
            vals = self._row_ids(flat.shape[0])
        else:
            vals = self.schema.pack_values(values, self.device)
        return self._insert_rows(st, *self._shard_rows(flat, vals))

    def _insert_rows(self, st: TableState, k: torch.Tensor, v: torch.Tensor) -> TableState:
        """:meth:`insert` of ``(local, n_local[, W])`` key and value rows."""
        if len(st.deltas) >= self.max_deltas:
            raise RuntimeError(
                f"delta ring full ({self.max_deltas} deltas); call compact() "
                "to fold deltas into the base before inserting more"
            )
        num_keys = k.shape[1] * self.num_shards
        coherent_build = self.coherent_deltas
        offsets = None
        if coherent_build and self.replicate_hot_keys > 1:
            # One-key skew no split fixes: spread each hot key's rows over R
            # consecutive owners before the guard checks the batch.  The
            # ranks are over the whole batch: every shard's rows (stacked
            # already; one all_gather over a process group).
            offsets = self._replica_offsets(k)
        if coherent_build and self.skew_guard:
            if self._coherent_dispatch_overflows(k, st.base.hash_splits, offsets):
                coherent_build = False
                self.skew_fallbacks += 1
        if coherent_build:
            local_cap, stride = self._delta_bucket_geometry(num_keys)
            delta = self._build(
                k,
                v,
                hash_range=self.hash_range,
                num_bins=None,
                hash_splits=st.base.hash_splits,
                local_range_cap=local_cap,
                bucket_stride=stride,
                dest_offsets=offsets,
            )
            coherent = st.coherent
        else:
            hr = self._delta_hash_range(num_keys)
            delta = self._build(k, v, hash_range=hr, num_bins=self._num_bins_for(hr))
            coherent = False  # mixed-split stack: per-layer routing from now on
        return dataclasses.replace(st, deltas=st.deltas + (delta,), coherent=coherent)

    def delete(self, state, keys) -> TableState:
        """Functional delete: tombstone every current occurrence of ``keys``
        at the current epoch (later inserts stay visible).  ``keys`` is one
        unsharded array of any length (over a process group the same on every
        rank, checked); overflow past ``tombstone_capacity`` is counted in
        ``state.num_dropped``."""
        packed = self.schema.pack_keys(keys, self.device)
        self._check_replicated("delete", packed)
        return self._tombstone(as_state(self, state), packed)

    def _tombstone(self, st: TableState, packed: torch.Tensor) -> TableState:
        """Push packed replicated keys as deletes at the current epoch."""
        ts = st.tombstones
        if ts.capacity == 0:
            # A zero-capacity buffer grows on the first delete.  It keeps the
            # clock (the reference restarts it at 0; ROADMAP.md, faults).
            ts = empty_tombstones(self.tombstone_capacity, ts.now, device=self.device,
                                  key_lanes=self.schema.key_lanes)
        return dataclasses.replace(st, tombstones=ts.push(packed, epoch=len(st.deltas)))

    def upsert(
        self,
        state,
        keys,
        values=None,
        *,
        ttl: Optional[int] = None,
        auto_compact: bool = False,
    ) -> TableState:
        """Functional insert-or-replace: afterwards ``keys`` map to exactly
        ``values``.

        Prior versions are tombstoned at the current epoch ``d`` and the new
        rows land in a fresh delta at ``d + 1``.  Within a batch the last
        occurrence of a key wins (host-side keep-last dedup).  ``ttl``
        pushes a pending tombstone at the new epoch that takes effect when
        the clock reaches ``now + ttl``.  ``keys`` need not divide into the
        shards: the batch is EMPTY-padded (padding is never tombstoned).
        Over a process group the batch is replicated, as for :meth:`delete`
        (checked), and each rank inserts its block of the padded batch.
        """
        st = as_state(self, state)
        kn = self.schema.pack_keys(keys, "cpu").numpy()
        if values is None:
            vn = self.schema.default_values(kn.shape[0], "cpu").numpy()
        else:
            vn = self.schema.pack_values(values, "cpu").numpy()
        self._check_replicated("upsert", kn, vn)
        if auto_compact and st.should_compact():
            st = self.compact(st)
        # Keep-last dedup: one winner per key, EMPTY rows dropped (one word a
        # key: the int64 view of a 2-lane key, EMPTY -1 either way).
        words = kn if kn.ndim == 1 else np.ascontiguousarray(kn).view(np.int64)[:, 0]
        _, first = np.unique(words[::-1], return_index=True)
        keep = np.sort(kn.shape[0] - 1 - first)
        keep = keep[words[keep] != EMPTY_BITS]
        if keep.shape[0] == 0:
            return st
        real = torch.from_numpy(kn[keep]).to(self.device)
        vals = torch.from_numpy(vn[keep]).to(self.device)
        pad = (-real.shape[0]) % self.num_shards
        padded_keys = torch.cat([real, real.new_full((pad,) + real.shape[1:], EMPTY_BITS)])
        padded_vals = torch.cat([vals, vals.new_full((pad,) + vals.shape[1:], -1)])
        st = self._tombstone(st, real)  # hide prior versions: epoch d
        st = self._insert_rows(st, self._deal(padded_keys), self._deal(padded_vals))  # d + 1
        if ttl is not None:
            ts = st.tombstones
            ts = ts.push(real, epoch=len(st.deltas), expires=ts.now + int(ttl))
            st = dataclasses.replace(st, tombstones=ts)
        return st

    def compact(self, state, *, capacity: Optional[int] = None) -> TableState:
        """Fold base + deltas - tombstones into a fresh base; reset the ring.

        Every layer's rows are masked to EMPTY where tombstoned, concatenated
        per shard, dealt round-robin across the shards (one exchange call)
        and rebuilt (the build's one dispatch).  With ``capacity=None`` the
        live row count (a sum, no exchange; a ``psum`` over a process group)
        sizes the rebuild, so steady
        insert/delete/compact cycles keep the base flat; the sizing is
        memoised per state signature (shapes, the same on every rank).
        ``capacity`` pins the rebuild's per-destination slot size.
        """
        st = as_state(self, state)
        d = self.num_shards
        n_cat_local = sum(layer.local.keys.shape[1] for layer in st.layers)
        rebuild_rows = None
        if capacity is None:
            sig = plans.state_signature(st)
            cached = self._sizing_memo.get(sig)
            if cached is not None:
                capacity, rebuild_rows = cached
            else:
                live_local = cdiv(int(plans.exec_live_count(self, st)), d)
                # Post-deal rows per shard: the balanced live share plus the
                # slack; live rows lost to skew beyond it are counted.
                rebuild_rows = max(64, int(live_local * self.capacity_slack) + 8)
                rebuild_rows = min(cdiv(rebuild_rows, 8) * 8, n_cat_local)
                capacity = multi_hashgraph.default_capacity(
                    rebuild_rows, d, self.capacity_slack
                ) + cdiv(rebuild_rows, d)
                if len(self._sizing_memo) >= 128:
                    self._sizing_memo.clear()
                self._sizing_memo[sig] = (capacity, rebuild_rows)
        capacity = cdiv(capacity, 8) * 8
        new_base = self._compact_base(st, capacity, rebuild_rows)
        # Tombstone carry: effective entries are spent by the rebuild; pending
        # TTL entries masked nothing yet, so they survive (clamped to epoch 0).
        ts = st.tombstones
        pending = ts.capacity > 0 and bool(((ts.epochs >= 0) & (ts.now < ts.expires)).any())
        if pending:
            from repro_torch.core.maintenance import _remap_tombstones

            new_ts = _remap_tombstones(ts, len(st.deltas))
        else:
            new_ts = empty_tombstones(0, ts.now, device=self.device,
                                      key_lanes=self.schema.key_lanes)
        return TableState(base=new_base, deltas=(), tombstones=new_ts, table=self)

    def _compact_rows(self, st: TableState, rebuild_rows: Optional[int]):
        """The rows a compaction rebuilds: ``(keys, values, truncated_live)``,
        keys ``(local, rows[, L])`` and values ``(local, rows[, C])``, live
        rows first on every shard; ``truncated_live`` is the local rows'."""
        ts_keys, ts_epochs = st.tombstones.index()
        lanes, cols = self.schema.key_lanes, self.schema.value_cols
        keys_parts, vals_parts = [], []
        for epoch, layer in enumerate(st.layers):
            k = layer.local.keys
            hidden = hashgraph.match_epochs_sorted(k, ts_keys, ts_epochs) >= epoch
            dead = hashgraph.is_empty_key(k, lanes) | hidden
            keys_parts.append(torch.where(dead.unsqueeze(-1) if lanes > 1 else dead, EMPTY_BITS, k))
            vals_parts.append(layer.local.values)
        local, d = keys_parts[0].shape[0], self.num_shards
        # One row of L key lanes and C value columns.
        rows = torch.cat([torch.cat(keys_parts, 1).reshape(local, -1, lanes),
                          torch.cat(vals_parts, 1).reshape(local, -1, cols)], dim=-1)
        del keys_parts, vals_parts
        width = lanes + cols
        # Strided deal: row i of every shard goes to shard i % D (the base is
        # hash-partitioned, so rebuilding as it is would send each shard's
        # live rows to one owner).  Keys and values travel as one exchange.
        m = rows.shape[1]
        chunk = cdiv(m, d)
        if chunk * d != m:
            pad = rows.new_full((local, chunk * d - m, width), -1)
            rows = torch.cat([rows, pad], dim=1)
        stripes = rows.reshape(local, chunk, d, width).transpose(1, 2)  # (src, D_dst, chunk, W)
        rows = exchange.all_to_all_hierarchical(stripes, self.group).reshape(
            local, d * chunk, width)
        del stripes
        # Live rows first: dispatch drops hit sentinels before any real key.
        empty = (rows[..., :lanes] == EMPTY_BITS).all(-1)
        order = torch.sort(empty.to(torch.int32), dim=1, stable=True).indices
        rows = take_rows(rows, order)
        empty = torch.gather(empty, 1, order)
        del order
        trunc_live = 0
        if rebuild_rows is not None and rebuild_rows < rows.shape[1]:
            trunc_live = (~empty[:, rebuild_rows:]).sum()
            rows = rows[:, :rebuild_rows]
        keys = rows[..., :lanes].contiguous()
        values = rows[..., lanes:].contiguous()
        return (keys[..., 0] if lanes == 1 else keys), (
            values[..., 0] if cols == 1 else values), trunc_live

    def _compact_base(
        self, st: TableState, capacity: int, rebuild_rows: Optional[int]
    ) -> DistributedHashGraph:
        keys, values, trunc_live = self._compact_rows(st, rebuild_rows)
        built = self._build(
            keys, values, hash_range=self.hash_range, num_bins=self.num_bins, capacity=capacity
        )
        # Live rows cut by the live-count sizing are counted, never silent
        # (the cut is taken on every rank alike: the shapes agree).
        if isinstance(trunc_live, torch.Tensor):
            trunc_live = self.group.psum(trunc_live)
        return dataclasses.replace(built, num_dropped=built.num_dropped + trunc_live)

    # -- reads ----------------------------------------------------------------
    def query(self, state, queries) -> torch.Tensor:
        """Multiplicity of each global query key over ``base + deltas -
        tombstones``, ``(Nq,)`` int32.

        With registered hot keys, one more routed round per replica rank
        adds the counts of rows spread off their hash owner (a key that was
        not replicated counts 0 off its owner, so the sum is exact for every
        key); without, this is the one fused round.
        """
        st = as_state(self, state)
        q = self._pack_queries(queries)
        total = plans.exec_query(self, st, q)
        for r in range(1, max(self.hot_keys.values(), default=1)):
            total = total + plans.exec_query(self, st, q, dest_offset=r)
        return total.reshape(-1)

    def contains(self, state, queries) -> torch.Tensor:
        return self.query(state, queries) > 0

    def join_size(self, state, queries) -> torch.Tensor:
        """Global inner-join cardinality (int64 scalar tensor)."""
        st = as_state(self, state)
        return plans.exec_join_size(self, st, self._pack_queries(queries))

    def plan_caps(self, state, queries) -> tuple[int, int]:
        """One counts round sizing retrieval exactly: ``(seg, out)`` ints."""
        st = as_state(self, state)
        return plans.exec_plan_caps(self, st, self._pack_queries(queries))

    def _resolve_caps(self, state: TableState, q: torch.Tensor, out_capacity, seg_capacity):
        """Count-first static output sizing, as in the reference: a ``None``
        capacity triggers the counts round; ``out`` is sized exactly,
        ``seg`` to the next power of two, both to a multiple of 8."""
        if out_capacity is None or seg_capacity is None:
            seg_need, out_need = plans.exec_plan_caps(self, state, q)
            if out_capacity is None:
                out_capacity = out_need
            if seg_capacity is None:
                seg_capacity = (
                    max(8, 1 << (seg_need - 1).bit_length()) if seg_need > 0 else 8
                )
        out_cap = max(8, cdiv(out_capacity, 8) * 8)
        seg_cap = max(8, cdiv(seg_capacity, 8) * 8)
        return out_cap, seg_cap

    # -- plans -------------------------------------------------------------------
    def plan_query(self, num_queries: Optional[int] = None) -> QueryPlan:
        """A ``(state, queries) -> counts`` callable (no capacities), with
        ``.join_size(state, queries)`` under the same plan."""
        return QueryPlan(self, num_queries)

    def _plan_statics(self, name, state, queries, num_queries, out_capacity, seg_capacity):
        """``(num_queries, out_cap, seg_cap)`` of a plan: capacities left
        ``None`` are sized by the counts round against the sample ``(state,
        queries)`` (the plan itself never syncs); with both explicit no
        sample is needed."""
        if out_capacity is None or seg_capacity is None:
            if state is None or queries is None:
                raise ValueError(
                    f"{name} needs a (state, queries) sample to size "
                    "capacities, or explicit out_capacity and seg_capacity"
                )
            out_capacity, seg_capacity = self._resolve_caps(
                as_state(self, state), self._pack_queries(queries), out_capacity, seg_capacity
            )
        else:
            out_capacity = max(8, cdiv(out_capacity, 8) * 8)
            seg_capacity = max(8, cdiv(seg_capacity, 8) * 8)
        if num_queries is None and queries is not None:
            num_queries = self._global_len(len(queries))
        return num_queries, out_capacity, seg_capacity

    def plan_retrieve(
        self,
        state=None,
        queries=None,
        *,
        num_queries: Optional[int] = None,
        out_capacity: Optional[int] = None,
        seg_capacity: Optional[int] = None,
        per_layer_counts: bool = False,
    ) -> RetrievePlan:
        """A ``(state, queries) -> ShardRetrieval`` callable with fixed
        capacities (see :meth:`_plan_statics`); ``per_layer_counts`` fills
        ``layer_counts`` in the same return call on the fused path."""
        return RetrievePlan(
            self,
            *self._plan_statics(
                "plan_retrieve", state, queries, num_queries, out_capacity, seg_capacity
            ),
            per_layer_counts=per_layer_counts,
        )

    def plan_join(
        self,
        state=None,
        queries=None,
        *,
        num_queries: Optional[int] = None,
        out_capacity: Optional[int] = None,
        seg_capacity: Optional[int] = None,
    ) -> JoinPlan:
        """A ``(state, queries) -> ShardJoin`` callable with fixed capacities."""
        return JoinPlan(
            self,
            *self._plan_statics(
                "plan_join", state, queries, num_queries, out_capacity, seg_capacity
            ),
        )

    def retrieve(
        self,
        state,
        queries,
        *,
        out_capacity: Optional[int] = None,
        seg_capacity: Optional[int] = None,
        per_layer_counts: bool = False,
    ) -> ShardRetrieval:
        """All live values for every occurrence of every query key.

        Global layout: block ``d`` of ``offsets`` (``n_local + 1`` rows)
        indexes block ``d`` of ``values`` (``out_capacity`` rows).  Overflow
        is reported in ``num_dropped``, never silently truncated.
        ``per_layer_counts=True`` also returns ``layer_counts`` ``(Nq, L)``,
        each query's count split by layer, base first (on the fused path in
        the values' return call: still two exchange calls).
        """
        st = as_state(self, state)
        q = self._pack_queries(queries)
        out_cap, seg_cap = self._resolve_caps(st, q, out_capacity, seg_capacity)
        return plans.global_retrieval(plans.exec_retrieve(
            self, st, q, out_capacity=out_cap, seg_capacity=seg_cap,
            per_layer_counts=per_layer_counts,
        ))

    def inner_join(
        self,
        state,
        queries,
        *,
        out_capacity: Optional[int] = None,
        seg_capacity: Optional[int] = None,
    ) -> ShardJoin:
        """Materialized inner join: global ``(query_idx, value)`` match pairs,
        shard ``d``'s in block ``d`` with its count in ``num_results[d]``."""
        st = as_state(self, state)
        q = self._pack_queries(queries)
        out_cap, seg_cap = self._resolve_caps(st, q, out_capacity, seg_capacity)
        return plans.global_join(
            plans.exec_join(self, st, q, out_capacity=out_cap, seg_capacity=seg_cap))

    # -- capacity-doubling retries ------------------------------------------------
    def _auto_retry(self, exec_fn, state, queries, out_capacity, seg_capacity, max_retries):
        """Re-run ``exec_fn`` with doubled caps while ``num_dropped > 0``
        (global over the group, so every rank retries alike).

        Stops early when doubling no longer shrinks ``num_dropped``: drops
        of the dispatch stage depend on ``capacity_slack``, not on the
        output caps, so no doubling fixes them.
        """
        st = as_state(self, state)
        q = self._pack_queries(queries)
        out_cap, seg_cap = self._resolve_caps(st, q, out_capacity, seg_capacity)
        res = exec_fn(self, st, q, out_capacity=out_cap, seg_capacity=seg_cap)
        dropped = int(res.num_dropped)
        for _ in range(max_retries):
            if dropped == 0:
                break
            out_cap, seg_cap = out_cap * 2, seg_cap * 2
            res = exec_fn(self, st, q, out_capacity=out_cap, seg_capacity=seg_cap)
            prev, dropped = dropped, int(res.num_dropped)
            if dropped >= prev:
                break  # not a capacity problem (e.g. route drops)
        return res

    def retrieve_auto(
        self,
        state,
        queries,
        *,
        out_capacity: Optional[int] = None,
        seg_capacity: Optional[int] = None,
        max_retries: int = 4,
    ) -> ShardRetrieval:
        """:meth:`retrieve` with at most ``max_retries`` capacity doublings
        while ``num_dropped > 0``; returns the last attempt either way."""
        return plans.global_retrieval(self._auto_retry(
            plans.exec_retrieve, state, queries, out_capacity, seg_capacity, max_retries))

    def inner_join_auto(
        self,
        state,
        queries,
        *,
        out_capacity: Optional[int] = None,
        seg_capacity: Optional[int] = None,
        max_retries: int = 4,
    ) -> ShardJoin:
        """:meth:`inner_join` with bounded capacity-doubling retries."""
        return plans.global_join(self._auto_retry(
            plans.exec_join, state, queries, out_capacity, seg_capacity, max_retries))


# ---------------------------------------------------------------------------
# Host-side views
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def retrieval_to_lists(result: ShardRetrieval) -> list:
    """One np.ndarray of values per global query (vectorized block slicing):
    ``(k,)`` for one value column, ``(k, C)`` for C."""
    counts = _np(result.counts)
    offsets = _np(result.offsets)
    values = _np(result.values)
    d = offsets.shape[0] - counts.shape[0]
    n_local = counts.shape[0] // d
    out_cap = values.shape[0] // d
    off2 = offsets.reshape(d, n_local + 1)
    flat = np.concatenate(
        [values[s * out_cap : s * out_cap + off2[s, -1]] for s in range(d)], axis=0
    )
    lens = np.diff(off2, axis=1).reshape(-1)
    return np.split(flat, np.cumsum(lens)[:-1])


def join_to_pairs(result: ShardJoin) -> np.ndarray:
    """``(M, 1 + C)`` int32 rows ``(query_idx, *value_columns)`` of every
    valid pair (``(M, 2)`` for one column)."""
    qi = _np(result.query_idx)
    vals = _np(result.values)
    if vals.ndim == 1:
        vals = vals[:, None]
    nres = _np(result.num_results)
    d = nres.shape[0]
    out_cap = qi.shape[0] // d
    mask = np.arange(out_cap)[None, :] < nres[:, None]
    qi_sel = qi.reshape(d, out_cap)[mask]
    vals_sel = vals.reshape(d, out_cap, -1)[mask]
    return np.concatenate([qi_sel[:, None], vals_sel], axis=1).astype(np.int32)
