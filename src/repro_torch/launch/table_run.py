"""One pass over the table's main path, the same calls in a stacked run and
in every rank of a process group.

:func:`run_slice` drives ``DistributedHashTable`` through the paper's path
and the versioned one: ``init``; ``query`` / ``contains`` / ``join_size``;
``plan_caps``, ``retrieve`` (also with ``per_layer_counts``),
``inner_join``, ``retrieve_auto`` and ``inner_join_auto``; two coherent
inserts, a ``delete``, an ``upsert(ttl=)``, reads at depth through the
sorted and the probe (``paper_faithful_probe=True``) query, the clock past
the TTL, ``fold_oldest``, an insert skewed onto shard 0 that takes the skew
guard's fallback (at D >= 2), reads of the mixed-split stack, ``compact``
and reads again (``versioned=False`` stops after the base's reads, the
``torchrun`` entry's pass).  Every output goes to a *sink* as its ``(local, ...)``
blocks, one a shard this caller holds, so rank ``r``'s blocks compare with
block ``r`` of a stacked run of ``D`` shards; scalars (global in both) go
apart.  Each entry point runs inside ``counting.scoped``: its exchange
rounds, kernel launches, reductions and wall are recorded per step.

The data is drawn from ``seed`` with numpy, the whole of it in every
process: a stacked run passes the global arrays, a rank its block of the
keys and queries, and the replicated ``delete`` / ``upsert`` batches whole.
The module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import counting
from repro_torch.core import hashing
from repro_torch.core.maintenance import fold_oldest
from repro_torch.core.schema import TableSchema
from repro_torch.core.table import DistributedHashTable

EMPTY_U32 = np.uint32(0xFFFFFFFF)
UPSERT_TTL = 5


@dataclasses.dataclass(frozen=True)
class SliceConfig:
    """Sizes of one pass (global counts, divisible by the shard count)."""

    n_keys: int
    wide: bool = False  # u64 keys x 2 value columns (fingerprint lane on)
    seed: int = 0
    queries: Optional[int] = None  # default n_keys / 4
    batch: Optional[int] = None  # each insert, default n_keys / 8
    replicated: Optional[int] = None  # delete and upsert batches, default n_keys / 32
    tombstone_capacity: Optional[int] = None  # default 4 x replicated
    hash_range: Optional[int] = None  # default n_keys


def _u64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))


def make_data(cfg: SliceConfig, d: int) -> dict:
    """The pass's global arrays from ``cfg.seed`` (numpy; the same in every
    process).  uint32 keys repeat (uniform over half the key count) with a
    few EMPTY sentinels; wide keys are ``lo | hi << 32`` with ``hi`` in
    ``[0, 4)``, so distinct keys share their low lane, and two value
    columns."""
    n = cfg.n_keys
    nq = cfg.queries or n // 4
    nb = cfg.batch or n // 8
    nr = cfg.replicated or max(8, n // 32)
    for what, m in (("n_keys", n), ("queries", nq), ("batch", nb)):
        if m % d:
            raise ValueError(f"{what} {m} is not divisible by {d} shards")
    rng = np.random.default_rng(cfg.seed)
    half = max(1, n // 2)
    keys = rng.integers(0, half, size=n, dtype=np.uint32)
    keys[3::97] = EMPTY_U32
    present = keys[rng.integers(0, n, size=nq // 2)]
    absent = rng.integers(half, 2 * half + 64, size=nq - nq // 2, dtype=np.uint32)
    queries = np.concatenate([present, absent])
    rng.shuffle(queries)
    ins = [rng.integers(0, half, size=nb, dtype=np.uint32) for _ in range(2)]
    dels = keys[rng.integers(0, n, size=nr)]
    dels = dels[dels != EMPTY_U32]
    ups = np.concatenate([keys[rng.integers(0, n, size=nr // 2)],
                          rng.integers(half, 2 * half, size=nr - nr // 2, dtype=np.uint32)])
    ups = ups[ups != EMPTY_U32]
    data = {"keys": keys, "queries": queries, "ins0": ins[0], "ins1": ins[1],
            "dels": dels, "ups": ups}
    if cfg.wide:
        for name in list(data):
            a = data[name]
            hi = rng.integers(0, 4, size=a.shape[0], dtype=np.uint32)
            hi = np.where(a == EMPTY_U32, EMPTY_U32, hi).astype(np.uint32)
            data[name] = _u64(a, hi)
        cols = 2
        data["values"] = rng.integers(-2**31, 2**31, size=(n, cols), dtype=np.int64).astype(np.int32)
        for name in ("ins0", "ins1"):
            data[name + "_values"] = rng.integers(
                -2**31, 2**31, size=(nb, cols), dtype=np.int64).astype(np.int32)
        data["ups_values"] = rng.integers(
            -2**31, 2**31, size=(data["ups"].shape[0], cols), dtype=np.int64).astype(np.int32)
    else:
        data["values"] = rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
        data["ups_values"] = rng.integers(
            -2**31, 2**31, size=data["ups"].shape[0], dtype=np.int64).astype(np.int32)
    return data


def skewed_batch(table, state, n: int, seed: int) -> np.ndarray:
    """``n`` keys whose hashes fall in shard 0's range of the base's splits
    (drawn from ``seed`` on the host and hashed on the table's device, the
    same in every process): a batch that overflows the frozen-splits
    dispatch at D >= 2."""
    splits = state.base.hash_splits.cpu().numpy()
    lanes = table.schema.key_lanes
    rng = np.random.default_rng(seed + 7)
    picked, have = [], 0
    while have < n:
        cand = rng.integers(0, 2**31, size=4 * n + 64, dtype=np.uint32)
        packed = torch.from_numpy(cand.view(np.int32)).to(table.device)
        if lanes == 2:
            packed = torch.stack([packed, torch.zeros_like(packed)], dim=-1)
        h = hashing.hash_to_buckets(packed.unsqueeze(0), table.hash_range, table.seed,
                                    lanes)[0].cpu().numpy()
        keep = cand[(h >= splits[0]) & (h < splits[1])]
        picked.append(keep)
        have += keep.shape[0]
    out = np.concatenate(picked)[:n]
    return _u64(out, np.zeros_like(out)) if lanes == 2 else out


class Sink:
    """Collects a pass's outputs as numpy: ``blocks[name]`` ``(local,
    ...)``, ``scalars[name]``.  Subclasses may compare or digest instead."""

    def __init__(self):
        self.blocks, self.scalars = {}, {}

    def put(self, name: str, blocks: torch.Tensor) -> None:
        self.blocks[name] = blocks.detach().cpu().numpy()

    def scalar(self, name: str, value) -> None:
        self.scalars[name] = value


def _blocks(t: torch.Tensor, local: int) -> torch.Tensor:
    """A global-layout output (shard blocks along dim 0) as ``(local, ...)``."""
    return t.reshape(local, -1, *t.shape[1:])


def run_slice(cfg: SliceConfig, sink: Sink, *, group=None, num_shards: int = 1,
              device=None, keep_state: bool = False, versioned: bool = True) -> dict:
    """One pass of the table's path (see the module docstring).

    ``group=None`` stacks ``num_shards`` shards on ``device``; a shard group
    puts this process's shard there.  ``device=None`` is the table's
    default: the (rank's) CUDA card, and an error where there is none; the
    CPU runs only as ``device="cpu"``.  Returns ``{"steps": {entry: {"rounds",
    "plan_rounds", "launches", "collectives", "wall_s"}}, "local", "shards"}``
    (and the tables, the final state, this caller's queries and the global
    data where ``keep_state``).
    """
    schema = TableSchema("uint64", 2) if cfg.wide else TableSchema()
    kw = dict(hash_range=cfg.hash_range or cfg.n_keys, schema=schema, device=device,
              tombstone_capacity=cfg.tombstone_capacity
              or 4 * (cfg.replicated or max(8, cfg.n_keys // 32)))
    if group is None:
        table = DistributedHashTable(num_shards=num_shards, **kw)
    else:
        table = DistributedHashTable(group=group, **kw)
    probe = dataclasses.replace(table, paper_faithful_probe=True)
    d, local, rank = table.num_shards, table.group.local, table.group.rank
    data = make_data(cfg, d)
    dev = table.device

    def mine(a: np.ndarray) -> np.ndarray:
        """This caller's shards' block of a global array."""
        m = a.shape[0] // d
        return a[rank * m : (rank + local) * m]

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
        steps[name] = {
            "rounds": scope.rounds.get("exchange", 0),
            "plan_rounds": scope.rounds.get("plan_caps", 0),
            "launches": dict(scope.launches),
            "collectives": dict(scope.collectives),
            "bytes": scope.exchange_bytes,
            "wall_s": wall,
        }
        return out

    def put_graph(tag: str, g) -> None:
        sink.put(f"{tag}.offsets", g.local.offsets)
        sink.put(f"{tag}.keys", g.local.keys)
        sink.put(f"{tag}.values", g.local.values)
        if g.local.fingerprints is not None:
            sink.put(f"{tag}.fingerprints", g.local.fingerprints)
        sink.scalar(f"{tag}.hash_splits", g.hash_splits.cpu().numpy().tolist())
        sink.scalar(f"{tag}.num_dropped", int(g.num_dropped))

    def put_retrieval(tag: str, r) -> None:
        sink.put(f"{tag}.offsets", _blocks(r.offsets, local))
        sink.put(f"{tag}.values", _blocks(r.values, local))
        sink.put(f"{tag}.counts", _blocks(r.counts, local))
        if r.layer_counts is not None:
            sink.put(f"{tag}.layer_counts", _blocks(r.layer_counts, local))
        sink.scalar(f"{tag}.num_dropped", int(r.num_dropped))

    def put_join(tag: str, j) -> None:
        sink.put(f"{tag}.query_idx", _blocks(j.query_idx, local))
        sink.put(f"{tag}.values", _blocks(j.values, local))
        sink.put(f"{tag}.num_results", j.num_results.reshape(local, 1))
        sink.scalar(f"{tag}.num_dropped", int(j.num_dropped))

    q = mine(data["queries"])

    def reads(tag: str, st, full: bool) -> None:
        sink.put(f"{tag}.query", _blocks(step(f"{tag}.query", lambda: table.query(st, q)), local))
        if full:
            sink.put(f"{tag}.probe_query", _blocks(
                step(f"{tag}.probe_query", lambda: probe.query(st, q)), local))
            sink.put(f"{tag}.contains", _blocks(table.contains(st, q), local))
            sink.scalar(f"{tag}.join_size", int(step(f"{tag}.join_size",
                                                     lambda: table.join_size(st, q))))
            caps = step(f"{tag}.plan_caps", lambda: table.plan_caps(st, q))
            sink.scalar(f"{tag}.plan_caps", list(caps))
        put_retrieval(f"{tag}.retrieve", step(f"{tag}.retrieve", lambda: table.retrieve(st, q)))
        if full:
            put_retrieval(f"{tag}.retrieve_layers", step(
                f"{tag}.retrieve_layers", lambda: table.retrieve(st, q, per_layer_counts=True)))
            put_join(f"{tag}.inner_join", step(f"{tag}.inner_join",
                                               lambda: table.inner_join(st, q)))

    # -- the read path on the base -----------------------------------------
    state = step("init", lambda: table.init(mine(data["keys"]), mine(data["values"])))
    put_graph("base", state.base)
    reads("r0", state, full=True)
    # The retries start from a quarter of the exact caps: two doublings.
    seg_cap, out_cap = (max(8, c // 4) for c in table.plan_caps(state, q))
    put_retrieval("r0.retrieve_auto", step("r0.retrieve_auto", lambda: table.retrieve_auto(
        state, q, out_capacity=out_cap, seg_capacity=seg_cap)))
    put_join("r0.inner_join_auto", step("r0.inner_join_auto", lambda: table.inner_join_auto(
        state, q, out_capacity=out_cap, seg_capacity=seg_cap)))
    if not versioned:
        return _finish(table, probe, state, q, data, steps, keep_state)

    # -- the versioned path ------------------------------------------------
    for i in range(2):
        vals = data.get(f"ins{i}_values")
        state = step(f"insert{i}", lambda: table.insert(
            state, mine(data[f"ins{i}"]), None if vals is None else mine(vals)))
    state = step("delete", lambda: table.delete(state, data["dels"]))
    state = step("upsert", lambda: table.upsert(state, data["ups"], data["ups_values"],
                                                ttl=UPSERT_TTL))
    sink.scalar("upsert.tombstones", [state.tombstones.count, state.tombstones.num_dropped,
                                      state.tombstones.now])
    put_graph("delta2", state.deltas[-1])
    reads("r3", state, full=True)
    state = state.advance(state.now + UPSERT_TTL)  # the upserted rows expire
    reads("r3_expired", state, full=False)
    state = step("fold_oldest", lambda: fold_oldest(state, 2))
    put_graph("folded", state.base)
    reads("r_fold", state, full=True)
    fallbacks = table.skew_fallbacks
    skew = skewed_batch(table, state, cfg.batch or cfg.n_keys // 8, cfg.seed)
    state = step("insert_skewed", lambda: table.insert(
        state, mine(skew), None if not cfg.wide else np.zeros((mine(skew).shape[0], 2), np.int32)))
    sink.scalar("skew.fallback", table.skew_fallbacks - fallbacks)
    sink.scalar("skew.coherent", bool(state.coherent))
    reads("r_mixed", state, full=True)
    state = step("compact", lambda: table.compact(state))
    put_graph("compacted", state.base)
    reads("r_compact", state, full=True)
    sink.scalar("state.num_dropped", int(state.num_dropped))
    return _finish(table, probe, state, q, data, steps, keep_state)


def _finish(table, probe, state, q, data, steps, keep_state: bool) -> dict:
    out = {"steps": steps, "local": table.group.local, "shards": table.num_shards,
           "device": table.device}
    if keep_state:
        out.update(table=table, probe=probe, state=state, queries=q, data=data)
    return out


def _ragged(values: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> tuple:
    """``values[starts[j] : starts[j] + lens[j]]`` for every j, concatenated,
    and the j of each entry."""
    lens = lens.astype(np.int64)
    first = np.cumsum(lens) - lens
    idx = np.repeat(starts.astype(np.int64) - first, lens) + np.arange(int(lens.sum()))
    return values[idx], np.repeat(np.arange(lens.shape[0]), lens)


def _sorted_in_rows(vals: np.ndarray, row: np.ndarray) -> np.ndarray:
    """``vals`` sorted within each run of equal ``row`` (rows ascending): by
    the row, then the value's 32-bit pattern, one argsort."""
    key = (row.astype(np.uint64) << np.uint64(32)) | (vals.astype(np.int64) & 0xFFFFFFFF
                                                      ).astype(np.uint64)
    return vals[np.argsort(key, kind="stable")]


def _rows_differing(want: np.ndarray, wrow: np.ndarray, got: np.ndarray, grow: np.ndarray,
                    n: int) -> np.ndarray:
    """(n,) bool: the rows whose multisets differ (each array sorted within
    its rows)."""
    wlen, glen = np.bincount(wrow, minlength=n), np.bincount(grow, minlength=n)
    bad = wlen != glen
    keep_w, keep_g = ~bad[wrow], ~bad[grow]
    neq = want[keep_w] != got[keep_g]
    bad[wrow[keep_w][neq]] = True
    return bad


def sampled_oracle(data: dict, seed: int, d: int, rank: int, blocks: dict,
                   samples: int) -> dict:
    """Rank ``rank``'s base reads (``blocks``: the ``r0.*`` outputs of its
    shard in a u32×1 pass, as numpy) against
    numpy: the query counts, and the retrieve's and the join's value
    multisets, of ``samples`` of its query rows drawn from ``seed`` (the
    base's live rows: every key but EMPTY).  Returns ``{"rows", "bad",
    "present"}``.  Every sampled row at once: the base rows of the sampled
    keys through a membership table over the live keys' range, each row's
    multisets sorted within rows by one argsort."""
    keys, values = data["keys"], data["values"]
    nq = data["queries"].shape[0] // d
    mine = data["queries"][rank * nq : (rank + 1) * nq]
    rows = np.random.default_rng(seed + 100 + rank).choice(nq, min(nq, samples), replace=False)
    n = rows.shape[0]
    # The base rows of the sampled keys only, sorted by key.
    live = keys != EMPTY_U32
    top = int(keys[live].max()) if live.any() else 0
    member = np.zeros(top + 1, bool)
    sample = np.unique(mine[rows])
    member[sample[sample <= top]] = True
    hit = live & member[np.minimum(keys, top)]
    order = np.argsort(keys[hit], kind="stable")
    skeys, svals = keys[hit][order], values[hit][order]
    counts = blocks["r0.query"].reshape(-1)
    offsets = blocks["r0.retrieve.offsets"].reshape(-1)
    rvals = blocks["r0.retrieve.values"].reshape(-1)
    nres = int(blocks["r0.inner_join.num_results"].reshape(-1)[0])
    # int64 once: a search with an int64 key would convert the array each time.
    qidx = blocks["r0.inner_join.query_idx"].reshape(-1)[:nres].astype(np.int64)
    jorder = np.argsort(qidx, kind="stable")
    qidx, jvals = qidx[jorder], blocks["r0.inner_join.values"].reshape(-1)[:nres][jorder]
    q = mine[rows]
    lo, hi = np.searchsorted(skeys, q, "left"), np.searchsorted(skeys, q, "right")
    want, wrow = _ragged(svals, lo, hi - lo)
    want = _sorted_in_rows(want, wrow)
    got_r, rrow = _ragged(rvals, offsets[rows], offsets[rows + 1] - offsets[rows])
    at = rank * nq + rows
    jlo, jhi = np.searchsorted(qidx, at, "left"), np.searchsorted(qidx, at, "right")
    got_j, jrow = _ragged(jvals, jlo, jhi - jlo)
    bad = (counts[rows] != hi - lo) \
        | _rows_differing(want, wrow, _sorted_in_rows(got_r, rrow), rrow, n) \
        | _rows_differing(want, wrow, _sorted_in_rows(got_j, jrow), jrow, n)
    return {"rows": int(n), "bad": int(bad.sum()), "present": int((counts[rows] > 0).sum())}
