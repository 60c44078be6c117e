"""The table's users in one pass, the same calls in a stacked run and in
every rank of a process group: hot-key replication and the KV cache.

:func:`run_users` drives

* **hot keys**: a ``DistributedHashTable(replicate_hot_keys=R)`` built on
  ``n_keys`` uniform keys, one insert of a zipfian batch of ``key_of``
  keys (the duplicate-heavy insert of the paper's abstract), the batch's
  replica offsets, ``query`` / ``contains`` of its distinct keys and base
  keys (R routed rounds each; the paper's probe query too, one kernel 5
  launch a layer a round), ``fold_oldest(1)``, ``compact()`` and a
  retrieve of the hot keys;
* **the KV cache**: a ``KVCache`` loaded with ``n_keys`` records, the
  YCSB letters of :func:`kv_script` (gets, contains and puts; the
  policy's folds), TTL puts read through their expiry, ``evict_expired``
  and the live count after each part.

Every output goes to a sink (``table_run.Sink``) as its ``(local, ...)``
blocks, so rank ``r``'s compare with block ``r`` of a stacked run of ``D``
shards; scalars (global in both) go apart.  Each call runs inside
``counting.scoped``: its exchange rounds, launches and reductions per step.

A get or contains batch is cut into ``D`` blocks of ``ceil(L / D)`` keys,
rank ``r`` asking block ``r`` (the last ones shorter, padded by the cache to
the longest); a stacked run asks the blocks EMPTY-padded and concatenated,
and a rank's answers are padded with the fill for the sink.  Puts are
replicated batches, as the cache takes them.  The data is drawn from
``seed`` with numpy, the whole of it in every process.  The module imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import counting
from repro_torch.cache import WORKLOADS, KVCache, YCSBWorkload, ZipfianGenerator, key_of
from repro_torch.core.maintenance import fold_oldest
from repro_torch.core.table import DistributedHashTable
from repro_torch.launch.table_run import EMPTY_U32, Sink, _blocks
from repro_torch.utils import cdiv

# The hot-keys phase's insert (the reference test's slack and R) and the
# kv-cache phase's at D = 8 (slack for zipfian reads), its letters and TTL.
HOT_THETA, HOT_REPLICAS, HOT_SLACK = 1.2, 4, 2.0
KV_LETTERS, KV_TTL, KV_SLACK = "AF", 4, 2.5


@dataclasses.dataclass(frozen=True)
class UsersConfig:
    """Sizes of one pass (global counts; ``n_keys`` and ``hot_batch``
    divisible by the shard count)."""

    n_keys: int
    seed: int = 0
    hot_batch: Optional[int] = None  # default n_keys / 4
    kv_batch: int = 1 << 13  # ops a YCSB generator batch; the tombstone buffer holds 16
    kv_ops: Optional[int] = None  # ops a letter, default 2 batches
    kv_ttl_keys: Optional[int] = None  # default n_keys / 4
    kv_max_deltas: int = 8  # the delta ring: the policy folds when it is full
    # (reads, writes) a batch: every get takes the first ``reads`` keys and
    # every put the first ``writes`` distinct keys (fixed shapes, no
    # padding), or the batch is skipped; None keeps the generator's batches
    # and ends with a get whose length no shard count divides.
    kv_fixed: Optional[tuple] = None


def hot_data(cfg: UsersConfig) -> dict:
    """The hot-key part's global arrays: the base, the zipfian batch and its
    values, the reads (distinct batch keys, then base keys) and the hot
    keys' retrieve batch is made from the registry at run time."""
    n = cfg.n_keys
    nb = cfg.hot_batch or n // 4
    rng = np.random.default_rng(cfg.seed + 2)
    base = rng.integers(0, n, size=n, dtype=np.uint32)
    ranks = ZipfianGenerator(nb, theta=HOT_THETA, seed=cfg.seed + 3).sample(nb)
    batch = key_of(ranks)
    vals = (n + np.arange(nb)).astype(np.int32)
    others = base[rng.choice(n, min(n, max(64, nb // 4)), replace=False)]
    return {"base": base, "batch": batch, "values": vals, "others": others}


def kv_script(cfg: UsersConfig) -> list:
    """The KV part as a list of ops, each a tuple: ``("get", keys)``,
    ``("contains", keys)``, ``("put", keys, values, ttl)``, ``("tick",)``,
    ``("live",)``, ``("evict",)``.  YCSB's letters (reads, scans and RMW
    reads are gets; updates, inserts and RMW writes are puts), then
    ``kv_ttl_keys`` loaded keys put with ``ttl = KV_TTL`` after an eviction
    (an empty buffer holds their tombstones), read at every tick through
    their expiry, then ``evict_expired``."""
    n = cfg.n_keys
    w = YCSBWorkload(WORKLOADS["A"], n, batch=cfg.kv_batch, seed=cfg.seed)
    ops = []
    last_get = None
    for letter in KV_LETTERS:
        w.spec = WORKLOADS[letter]
        for kind, keys, vals in w.batches(cfg.kv_ops or 2 * cfg.kv_batch):
            if kind in ("read", "scan", "rmw"):
                k = keys
                if cfg.kv_fixed is not None:
                    k = keys[: cfg.kv_fixed[0]] if keys.shape[0] >= cfg.kv_fixed[0] else None
                if k is not None:
                    ops.append(("get", k))
                    last_get = k
            if kind in ("update", "insert", "rmw"):
                k, v = keys, vals
                if cfg.kv_fixed is not None:
                    _, first = np.unique(keys, return_index=True)
                    first = np.sort(first)[: cfg.kv_fixed[1]]
                    k, v = (keys[first], vals[first]) if first.shape[0] == cfg.kv_fixed[1] \
                        else (None, None)
                if k is not None:
                    ops.append(("put", k, v, None))
        if last_get is not None:
            ops.append(("contains", last_get))
        ops.append(("live",))
    rng = np.random.default_rng(cfg.seed + 4)
    nt = cfg.kv_ttl_keys or n // 4
    ttl_keys = key_of(rng.choice(n, nt, replace=False))
    ops += [("evict",), ("put", ttl_keys, ((1 << 30) + np.arange(nt)).astype(np.int32), KV_TTL),
            ("get", ttl_keys)]
    for _ in range(KV_TTL):
        ops += [("tick",), ("get", ttl_keys)]
    ops += [("contains", ttl_keys), ("live",), ("evict",), ("live",)]
    if cfg.kv_fixed is None:
        ops.append(("get", key_of(np.arange(0, 2 * n, 2)[: 8 * 3 * 5 * 7 + 1])))
    return ops


def _get_blocks(keys: np.ndarray, d: int) -> tuple:
    """A get batch's ``d`` blocks of ``ceil(L / d)`` keys: ``(blocks,
    padded)``, ``padded`` the blocks EMPTY-padded and concatenated."""
    m = cdiv(keys.shape[0], d)
    padded = np.full(d * m, EMPTY_U32, np.uint32)
    blocks = [keys[r * m: (r + 1) * m] for r in range(d)]
    for r, b in enumerate(blocks):
        padded[r * m: r * m + b.shape[0]] = b
    return blocks, padded


def run_users(cfg: UsersConfig, sink: Sink, *, group=None, num_shards: int = 1,
              device=None, keep_state: bool = False) -> dict:
    """One pass of the hot-key and KV-cache parts (module docstring).

    ``group=None`` stacks ``num_shards`` shards on ``device``; a shard group
    puts this process's shard there.  ``device=None`` is the tables'
    default: the (rank's) CUDA card, and an error where there is none.
    Returns ``{"steps": {name: {"rounds", "launches", "collectives",
    "wall_s"}}, "local", "shards", "device"}`` (and the tables and final
    states where ``keep_state``)."""
    kw = dict(hash_range=cfg.n_keys, device=device)
    if group is not None:
        kw["group"] = group
    else:
        kw["num_shards"] = num_shards
    hot_table = DistributedHashTable(capacity_slack=HOT_SLACK, replicate_hot_keys=HOT_REPLICAS,
                                     **kw)
    d, local, rank = hot_table.num_shards, hot_table.group.local, hot_table.group.rank
    dev = hot_table.device
    steps = {}

    def step(name: str, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with counting.scoped() as scope:
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        steps[name] = {"rounds": scope.exchange_rounds, "launches": dict(scope.launches),
                       "collectives": dict(scope.collectives), "wall_s": wall}
        return out

    def mine(a: np.ndarray) -> np.ndarray:
        m = a.shape[0] // d
        return a[rank * m: (rank + local) * m]

    def put_graph(tag: str, g) -> None:
        sink.put(f"{tag}.offsets", g.local.offsets)
        sink.put(f"{tag}.keys", g.local.keys)
        sink.put(f"{tag}.values", g.local.values)
        sink.scalar(f"{tag}.num_dropped", int(g.num_dropped))

    # -- hot keys --------------------------------------------------------------
    h = hot_data(cfg)
    table = hot_table
    state = step("hot.init", lambda: table.init(mine(h["base"])))
    state = step("hot.insert", lambda: table.insert(state, mine(h["batch"]), mine(h["values"])))
    sink.scalar("hot.keys", sorted([list(k), r] for k, r in table.hot_keys.items()))
    sink.scalar("hot.skew_fallbacks", table.skew_fallbacks)
    sink.scalar("hot.num_dropped", int(state.num_dropped))
    packed = table.schema.pack_keys(mine(h["batch"]), dev).reshape(local, -1)
    offsets = table._replica_offsets(packed)
    sink.put("hot.offsets", offsets if offsets is not None else torch.zeros_like(packed))
    put_graph("hot.delta", state.deltas[0])
    uniq = np.unique(h["batch"])
    q = np.concatenate([uniq, h["others"]])
    q = np.concatenate([q, h["others"][: (-q.shape[0]) % d]])
    folded = None
    for tag in ("insert", "fold", "compact"):
        if tag == "fold":
            folded = step("hot.fold_oldest", lambda: fold_oldest(state, 1))
            put_graph("hot.folded", folded.base)
            st = folded
        elif tag == "compact":
            st = step("hot.compact", lambda: folded.compact())
            put_graph("hot.compacted", st.base)
        else:
            st = state
        sink.put(f"hot.{tag}.query", _blocks(step(f"hot.{tag}.query",
                                                  lambda: table.query(st, mine(q))), local))
        sink.scalar(f"hot.{tag}.num_dropped", int(st.num_dropped))
    sink.put("hot.contains", _blocks(step("hot.contains", lambda: table.contains(state, mine(q))),
                                     local))
    probe = dataclasses.replace(table, paper_faithful_probe=True)
    probe.hot_keys = table.hot_keys
    sink.put("hot.probe_query", _blocks(step("hot.probe_query",
                                             lambda: probe.query(state, mine(q))), local))
    hot = np.array(sorted(k[0] for k in table.hot_keys), np.uint32)
    hq = np.concatenate([hot, h["others"]])[: max(d, cdiv(hot.shape[0], d) * d)]
    res = step("hot.retrieve", lambda: table.retrieve(state, mine(hq)))
    sink.put("hot.retrieve.offsets", _blocks(res.offsets, local))
    sink.put("hot.retrieve.values", _blocks(res.values, local))
    sink.scalar("hot.retrieve.num_dropped", int(res.num_dropped))
    del folded, st, res
    hot_state = state

    # -- the KV cache --------------------------------------------------------------
    table = DistributedHashTable(capacity_slack=KV_SLACK, max_deltas=cfg.kv_max_deltas,
                                 tombstone_capacity=16 * cfg.kv_batch, **kw)
    # YCSB's load phase: record i is key_of(i) with value i.
    keys, values = key_of(np.arange(cfg.n_keys)), np.arange(cfg.n_keys, dtype=np.int32)
    cache = step("kv.load", lambda: KVCache(table, mine(keys), mine(values)))
    for i, op in enumerate(kv_script(cfg)):
        kind, name = op[0], f"kv.{i}.{op[0]}"
        if kind in ("get", "contains"):
            blocks, padded = _get_blocks(op[1], d)
            ask = padded if local == d else blocks[rank]
            out = step(name, lambda: getattr(cache, kind)(ask))
            m = padded.shape[0] // d
            if out.shape[0] < local * m:  # a rank's short block: pad as the stacked run's
                fill = np.full((local * m - out.shape[0],), -1 if kind == "get" else False,
                               out.dtype)
                out = np.concatenate([out, fill])
            sink.put(name, torch.from_numpy(out).reshape(local, m))
        elif kind == "put":
            step(name, lambda: cache.put(op[1], op[2], ttl=op[3]))
        elif kind == "tick":
            cache.tick()
        elif kind == "live":
            sink.scalar(name, step(name, cache.live_count))
            sink.scalar(f"kv.{i}.folds", [cache.folds, cache.evictions, cache.now])
            sink.scalar(f"kv.{i}.stats", dataclasses.astuple(cache.stats()))
        else:  # evict
            sink.scalar(name, step(name, cache.evict_expired))
    sink.scalar("kv.skew_fallbacks", table.skew_fallbacks)
    out = {"steps": steps, "local": local, "shards": d, "device": dev}
    if keep_state:
        out.update(hot_table=hot_table, hot_state=hot_state, hot_queries=q, hot_retrieve=hq,
                   kv_table=table, cache=cache)
    return out
