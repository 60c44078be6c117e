"""The port's observability layer against the JAX package's.

* The reference's registry, tracing and export cases run against both
  packages' modules, and one scripted sequence of operations renders the
  same Prometheus text, JSONL lines and trace dump in both (the stamps
  passed in, the fake clock's times).
* ``record_fold`` and ``fold_oldest(metrics=)`` leave the same registry
  values in both packages, the fold seconds aside.
* ``profile_executor`` reports two exchange rounds per query and retrieve
  at depths 0–3 and the bytes of the transposed buffers of one shard.  The
  reference's own profiler tests fail on jax 0.9 (they walk
  ``jax.core.ClosedJaxpr``), so the oracle here is the buffer formula.
* The per-thread counting: two threads count under different labels at
  once, and neither's scope sees the other's rounds or launches.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax
import jax.numpy as jnp

import repro.obs as jobs
from repro.core import maintenance as jmaintenance
from repro.core import table as jtable
import repro_torch.obs as pobs
from repro_torch import DistributedHashTable, counting
from repro_torch.core import exchange, maintenance, multi_hashgraph, plans
from repro_torch.kernels import build
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

OBS = pytest.mark.parametrize("obs", [jobs, pobs], ids=["repro", "repro_torch"])


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# The reference's registry, export and tracing cases, on both packages
# ---------------------------------------------------------------------------


@OBS
def test_counter_monotone_and_get_or_create(obs):
    reg = obs.MetricsRegistry()
    c1 = reg.counter("requests_total", help="x")
    c2 = reg.counter("requests_total")
    assert c1 is c2
    c1.inc()
    c1.inc(4)
    assert c2.value == 5
    with pytest.raises(ValueError):
        c1.inc(-1)
    a = reg.counter("by_kind_total", labels={"kind": "a"})
    b = reg.counter("by_kind_total", labels={"kind": "b"})
    assert a is not b
    a.inc(2)
    snap = reg.snapshot()
    assert snap.value("by_kind_total", {"kind": "a"}) == 2
    assert snap.value("by_kind_total", {"kind": "b"}) == 0
    assert snap.value("absent_total", default=-1) == -1


@OBS
def test_type_conflict_and_gauge(obs):
    reg = obs.MetricsRegistry()
    reg.counter("x_total")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")
    g = reg.gauge("depth")
    g.set(3)
    g.add(2)
    assert reg.snapshot().value("depth") == 5


@OBS
def test_histogram_quantiles(obs):
    reg = obs.MetricsRegistry()
    h = reg.histogram("one_seconds")
    h.observe(0.017)
    s = h.snapshot()
    assert s.count == 1 and s.p50 == pytest.approx(0.017) and s.p999 == pytest.approx(0.017)
    h = reg.histogram("lat_seconds")
    vals = [0.001] * 98 + [0.5, 1.0]
    for v in vals:
        h.observe(v)
    s = h.snapshot()
    assert s.count == 100 and s.sum == pytest.approx(sum(vals))
    assert s.min == pytest.approx(0.001) and s.max == pytest.approx(1.0)
    assert s.p50 == pytest.approx(0.001, rel=0.5)
    assert s.p999 >= 0.5
    assert s.quantile(1.0) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="sorted"):
        reg.histogram("bad", bounds=(2.0, 1.0))


@OBS
def test_snapshot_is_atomic_and_nested(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("a_total")
    h = reg.histogram("b_seconds")
    c.inc(7)
    h.observe(0.25)
    snap = reg.snapshot()
    c.inc(100)
    h.observe(9.0)
    assert snap.value("a_total") == 7
    assert snap.histogram("b_seconds").count == 1
    assert snap.as_dict()["b_seconds"]["count"] == 1
    reg.counter("folds_total", labels={"kind": "fold"}).inc(3)
    reg.counter("folds_total", labels={"kind": "full"}).inc(1)
    snap = reg.snapshot()
    assert {lab["kind"] for lab in snap.labels_of("folds_total")} == {"fold", "full"}
    assert snap.as_dict()["folds_total"] == {"kind=fold": 3, "kind=full": 1}


@OBS
def test_prometheus_round_trip_and_jsonl(obs, tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("reqs_total", help="Requests.").inc(42)
    reg.gauge("depth").set(3)
    h = reg.histogram("lat_seconds", labels={"phase": "device"})
    for v in (0.001, 0.004, 0.25):
        h.observe(v)
    text = obs.render_prometheus(reg)
    assert "# HELP reqs_total Requests." in text
    assert "# TYPE lat_seconds histogram" in text
    scraped = obs.parse_prometheus(text)
    assert scraped[("reqs_total", ())] == 42
    assert scraped[("lat_seconds_count", (("phase", "device"),))] == 3
    assert scraped[("lat_seconds_bucket", (("le", "+Inf"), ("phase", "device")))] == 3
    recs = [json.loads(line) for line in obs.render_jsonl(reg, run="unit", ts=123).splitlines()]
    assert {r["metric"] for r in recs} == {"reqs_total", "depth", "lat_seconds"}
    assert all(r["run"] == "unit" and r["ts"] == 123 for r in recs)
    path = tmp_path / "m.jsonl"
    obs.write_jsonl(str(path), reg, run="unit", ts=1)
    assert len(path.read_text().strip().splitlines()) == 3


@OBS
def test_tracer_phases_ring_and_clamps(obs):
    clock = FakeClock()
    reg = obs.MetricsRegistry()
    tr = obs.Tracer(reg, ring=2, clock=clock)
    for i in range(3):
        clock.t = i * 1.0
        t = tr.start(size=4)
        assert tr.live() == 1
        for j, phase in enumerate(obs.PHASES):
            t.mark(phase, i * 1.0 + 0.01 * (j + 1))
        tr.finish(t)
    snap = reg.snapshot()
    for phase in obs.PHASES:
        assert snap.histogram("trace_phase_seconds", {"phase": phase}).count == 3
    assert snap.histogram("request_latency_seconds").p50 == pytest.approx(0.05, rel=1e-6)
    assert [t.trace_id for t in tr.recent()] == [1, 2]
    t = obs.Tracer(obs.MetricsRegistry(), clock=clock).start()
    t.mark("admission", t.t0 + 0.1)
    t.mark("linger", t.t0 + 0.3)
    t.mark("dispatch", t.t0 + 0.2)  # clock skew: clamps to 0
    assert t.durations()["dispatch"] == 0.0 and "device" not in t.durations()
    off = obs.Tracer(obs.MetricsRegistry(), enabled=False)
    assert off.start() is None
    off.finish(None)
    off.abandon(None)


def _scripted(obs, tmp_path):
    """One sequence of registry and tracer operations; returns the Prometheus
    text, the JSONL text and the trace dump."""
    clock = FakeClock()
    reg = obs.MetricsRegistry()
    reg.counter("reqs_total", help="Requests.").inc(42)
    reg.counter("by_kind_total", labels={"kind": "a"}).inc(2)
    reg.counter("by_kind_total", labels={"kind": "b"})
    reg.gauge("depth", help="Depth.").set(3)
    reg.gauge("ratio").set(0.125)
    h = reg.histogram("lat_seconds", labels={"phase": "device"})
    for v in (0.001, 0.004, 0.25, 3.0, 1e-7):
        h.observe(v)
    reg.histogram("coarse_seconds", bounds=(0.01, 0.1, 1.0)).observe(0.05)
    tr = obs.Tracer(reg, ring=4, clock=clock)
    for i in range(5):
        clock.t = 10.0 + i
        t = tr.start(size=i + 1)
        for j, phase in enumerate(obs.PHASES[: 2 + i % 4]):
            t.mark(phase, clock.t + 0.003 * (j + 1))
        tr.finish(t) if i != 3 else tr.abandon(t)
    path = tmp_path / f"{obs.__name__}.jsonl"
    tr.dump_jsonl(str(path))
    return (obs.render_prometheus(reg), obs.render_jsonl(reg, run="parity", ts=7),
            path.read_text())


def test_rendered_text_is_identical_in_both_packages(tmp_path):
    want = _scripted(jobs, tmp_path)
    got = _scripted(pobs, tmp_path)
    for g, w in zip(got, want):
        assert g == w


# ---------------------------------------------------------------------------
# record_fold and fold_oldest(metrics=)
# ---------------------------------------------------------------------------


def _no_seconds(snap) -> dict:
    d = snap.as_dict()
    hist = d.pop("maintenance_fold_seconds")
    return {**d, "fold_counts": {k: v["count"] for k, v in hist.items()}}


def test_record_fold_matches_reference():
    regs = []
    for obs, mt in ((jobs, jmaintenance), (pobs, maintenance)):
        reg = obs.MetricsRegistry()
        mt.record_fold(None, kind="fold", seconds=0.1, rows_before=10, rows_after=5)
        mt.record_fold(reg, kind="fold", seconds=0.02, rows_before=100, rows_after=60)
        mt.record_fold(reg, kind="full", seconds=0.2, rows_before=60, rows_after=90)
        regs.append(reg.snapshot())
    assert regs[0].as_dict() == regs[1].as_dict()
    assert regs[1].value("maintenance_reclaimed_rows_total") == 40
    assert regs[1].value("maintenance_last_reclaimed_rows") == 0


@pytest.mark.parametrize("coherent", [True, False], ids=["fold", "full"])
def test_fold_oldest_metrics_match_reference(coherent, mesh8):
    kw = dict(hash_range=1 << 12, coherent_deltas=coherent)
    jt = jtable.DistributedHashTable(mesh8, ("d",), **kw)
    pt = DistributedHashTable(num_shards=8, device="cpu", **kw)
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 14, 512, dtype=np.uint32)
    js, ps = jt.init(jnp.asarray(keys)), pt.init(keys)
    for _ in range(3):
        ins = rng.integers(0, 1 << 14, 64, dtype=np.uint32)
        js, ps = js.insert(jnp.asarray(ins)), ps.insert(ins)
    jreg, preg = jobs.MetricsRegistry(), pobs.MetricsRegistry()
    jf = jmaintenance.fold_oldest(js, 2, metrics=jreg)
    pf = maintenance.fold_oldest(ps, 2, metrics=preg)
    assert len(pf.deltas) == len(jf.deltas)
    jsnap, psnap = jreg.snapshot(), preg.snapshot()
    assert _no_seconds(psnap) == _no_seconds(jsnap)
    kind = "fold" if coherent else "full"
    assert psnap.value("maintenance_folds_total", {"kind": kind}) == 1
    assert psnap.histogram("maintenance_fold_seconds", {"kind": kind}).sum > 0


# ---------------------------------------------------------------------------
# profile_executor and the per-thread counting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])
def test_profile_executor_rounds_and_bytes(d):
    pt = DistributedHashTable(num_shards=d, hash_range=1 << 12, device="cpu")
    rng = np.random.default_rng(5)
    state = pt.init(rng.integers(0, 1 << 12, 256, dtype=np.uint32))
    bucket = 16 * d
    q = plans._proto_queries(pt, bucket)
    cap = multi_hashgraph.default_capacity(bucket // d, d, pt.capacity_slack)
    out_cap, seg_cap = 64, 32
    for depth in range(4):
        cost = pobs.profile_executor(pt, state, q, kind="query")
        assert (cost.kind, cost.bucket, cost.depth) == ("query", bucket, depth)
        assert cost.all_to_alls == 2
        # Dispatch: D * capacity key words out; combine: as many counts back.
        assert cost.all_to_all_bytes == 2 * d * cap * 4
        assert cost.flops is None and cost.bytes_accessed is None
        r = pobs.profile_executor(pt, state, q, kind="retrieve",
                                  exec_kwargs={"out_capacity": out_cap, "seg_capacity": seg_cap})
        assert r.all_to_alls == 2
        # Dispatch as above; the ragged return: D segments and D * capacity counts.
        assert r.all_to_all_bytes == d * cap * 4 + d * seg_cap * 4 + d * cap * 4
        assert r.as_dict()["collective_counts"] == {"all_to_all": 2}
        state = state.insert(rng.integers(0, 1 << 12, 8 * d, dtype=np.uint32))
    compiled = pt.plan_query(num_queries=bucket).compile(state)
    assert pobs.profile_executor(pt, state, q, kind="query", compiled=compiled).all_to_alls == 2


class _FakeLibrary:
    def __getattr__(self, name):
        return lambda *args: 0


def test_two_threads_count_apart(monkeypatch):
    """Two threads read at once under different labels; each scope holds its
    own thread's rounds and launches only, and the process-wide counters
    hold both."""
    monkeypatch.setattr(build, "_lib", _FakeLibrary())
    pt = DistributedHashTable(num_shards=8, hash_range=1 << 12, device="cpu")
    rng = np.random.default_rng(7)
    state = pt.init(rng.integers(0, 1 << 12, 512, dtype=np.uint32))
    q = rng.integers(0, 1 << 12, 64, dtype=np.uint32)
    exchange.CALLS.clear()
    build.LAUNCHES.clear()
    barrier = threading.Barrier(2)
    scopes, errors = {}, []

    def worker(label, reps, kernel):
        try:
            with exchange.counting_as(label), counting.scoped() as scope:
                barrier.wait()
                for _ in range(reps):
                    pt.query(state, q)
                    build.launch(kernel)
            scopes[label] = scope
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=("a", 5, "ka")),
               threading.Thread(target=worker, args=("b", 3, "kb"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert dict(scopes["a"].rounds) == {"a": 10} and dict(scopes["b"].rounds) == {"b": 6}
    assert dict(scopes["a"].launches) == {"ka": 5} and dict(scopes["b"].launches) == {"kb": 3}
    assert dict(exchange.CALLS) == {"a": 10, "b": 6}
    assert dict(build.LAUNCHES) == {"ka": 5, "kb": 3}
    # Outside the blocks the threads' labels are gone from this thread too.
    exchange.CALLS.clear()
    pt.query(state, q)
    assert dict(exchange.CALLS) == {"exchange": 2}
    build.LAUNCHES.clear()
