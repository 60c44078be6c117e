"""The port's tooling held against the JAX package's on the CPU: the launch
resolver and the autotuner's cache (``kernels/common.py``,
``kernels/autotune.py``), the dry run over fake ranks
(``launch/dryrun.py``) and the roofline (``analysis/roofline.py``).

* The reference's ``test_autotune.py`` cases, parametrised over both
  packages where their meaning is shared: the resolution order (override,
  tuned winner, default), the nearest size bucket, the version-1 JSON file
  under ``REPRO_AUTOTUNE_CACHE``.  The caches are filled from a JSON file
  (the port's sweep times kernels on the card only; its card cases are in
  ``test_torch_cuda.py``); each package keys its entries by its backend
  (the reference's ``jax.default_backend()``, ``"cpu"`` here; the port's
  ``"cuda"``).  ``_size_bucket`` and ``_key`` agree over a grid, and a file
  written by either package's ``save_cache`` loads in the other.
* The dry run of the smoke qwen3-4b over a fake ``(2, 2)`` mesh (rank 0 of
  a fake group of 4): the collectives of its train step, prefill and decode
  step are the design's (``train_run.design_collectives``,
  ``lm_run.design_collectives``), its parameter bytes
  ``shard_bytes_per_device``; an unsharded prefill's FLOPs are the
  products' ``2 N`` a token plus the head on the last position and kernel
  6's causal pairs, within 1e-3 relative; ``model_flops`` equals the
  reference's for every arch and cell (the reference's run in a
  subprocess: importing its ``launch/dryrun.py`` sets ``XLA_FLAGS``).
* ``roofline.derive`` / ``summarize`` on the reference's
  ``test_roofline_summary_roundtrip`` record, with the H100 constants.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, SHAPE_SUITE, ShapeCell, get_config  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.kernels import autotune, common, ops  # noqa: E402

PACKAGES = {"reference": (jcommon, jautotune), "port": (common, autotune)}
KERNELS = ("murmur", "bin_histogram", "bucket_probe", "csr_gather", "csr_gather_batched")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_caches():
    """Every test starts and ends with both packages' caches empty."""
    for _, auto in PACKAGES.values():
        auto.clear_cache()
    yield
    for _, auto in PACKAGES.values():
        auto.clear_cache()


def _backend(auto) -> str:
    if auto is autotune:
        return autotune.BACKEND
    import jax

    return jax.default_backend()


def _write_cache(path, auto, kernel: str, n: int, width: int, block_rows: int) -> str:
    key = auto._key(kernel, _backend(auto), width, auto._size_bucket(n))
    path.write_text(json.dumps({"version": 1, "entries": {
        key: {"block_rows": block_rows, "best_ms": 0.5, "timings_ms": {str(block_rows): 0.5},
              "n": n, "width": width, "key": key}}}))
    return key


# ---------------------------------------------------------------------------
# the resolver and the cache, over both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", PACKAGES)
def test_defaults_table_and_override(pkg):
    """Resolution order: override > tuned > DEFAULT_BLOCK_ROWS."""
    com, _ = PACKAGES[pkg]
    for k in KERNELS:
        assert com.resolve_block_rows(k) == com.DEFAULT_BLOCK_ROWS[k]
    assert com.resolve_block_rows("murmur", 16) == 16  # override wins
    with pytest.raises(KeyError):
        com.resolve_block_rows("no_such_kernel")


def test_port_defaults_are_the_kernels_launch_geometry():
    """Untuned launches keep the geometry the kernels had: 256 threads x 4
    keys (murmur), 512 x 4 ids (histogram), 256 x 4 slots (probe), 256 x 8
    slots (the gathers); a tile the kernel was not built for is refused."""
    want = {"murmur": 256, "bin_histogram": 512, "bucket_probe": 256, "csr_gather": 256,
            "csr_gather_batched": 256}
    for k, threads in want.items():
        assert common.threads_for(k, common.DEFAULT_BLOCK_ROWS[k]) == threads
        assert common.DEFAULT_BLOCK_ROWS[k] in common.CANDIDATES[k]
        assert set(common.CANDIDATES[k]) <= set(jautotune.DEFAULT_CANDIDATES)
    assert [common.threads_for("csr_gather", b) for b in (8, 16, 32)] == [128, 256, 512]
    assert [common.threads_for("bucket_probe", b) for b in (4, 8)] == [128, 256]
    with pytest.raises(ValueError, match="block_rows 64"):
        common.threads_for("murmur", 64)
    assert tuple(autotune.KERNELS) == tuple(jautotune.KERNELS)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_nearest_bucket_fallback(pkg, tmp_path):
    com, auto = PACKAGES[pkg]
    _write_cache(tmp_path / "c.json", auto, "murmur", 1024, 1, 4)
    assert auto.load_cache(str(tmp_path / "c.json")) == 1
    assert auto.cached_block_rows("murmur", n=1024) == 4
    assert com.resolve_block_rows("murmur", n=1024) == 4
    assert com.resolve_block_rows("murmur", 32, n=1024) == 32  # override beats the winner
    # far-away size: the nearest tuned log2 bucket still informs the call
    assert auto.cached_block_rows("murmur", n=1 << 22) == 4
    # another kernel or width: no bleed-through
    assert auto.cached_block_rows("csr_gather", n=1024) is None
    assert auto.cached_block_rows("murmur", n=1024, width=2) is None
    assert auto.cached_block_rows("murmur", n=None) is None


@pytest.mark.parametrize("pkg", PACKAGES)
def test_json_cache_round_trip(pkg, tmp_path, monkeypatch):
    """load -> save -> clear -> load restores the winners; the file is
    version 1; ``REPRO_AUTOTUNE_CACHE`` names the path; a missing file loads
    nothing."""
    com, auto = PACKAGES[pkg]
    path = tmp_path / "autotune_cache.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    key = _write_cache(tmp_path / "seed.json", auto, "csr_gather", 2048, 2, 32)
    auto.load_cache(str(tmp_path / "seed.json"))
    assert auto.save_cache() == str(path)
    blob = json.loads(path.read_text())
    assert blob["version"] == 1 and blob["entries"][key]["block_rows"] == 32
    auto.clear_cache()
    default = com.DEFAULT_BLOCK_ROWS["csr_gather"]
    assert com.resolve_block_rows("csr_gather", n=2048, width=2) == default
    assert auto.load_cache() == 1
    assert com.resolve_block_rows("csr_gather", n=2048, width=2) == 32
    auto.clear_cache()
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "absent.json"))
    assert auto.load_cache() == 0


def test_size_bucket_and_key_match_reference():
    for n in (0, 1, 2, 3, 255, 256, 257, 1000, 1 << 20, (1 << 20) + 1, 1 << 24, 3 << 30):
        assert autotune._size_bucket(n) == jautotune._size_bucket(n), n
        for kernel in KERNELS:
            for width in (1, 2, 4):
                b = autotune._size_bucket(n)
                assert autotune._key(kernel, "cuda", width, b) == \
                    jautotune._key(kernel, "cuda", width, b)


@pytest.mark.parametrize("writer", PACKAGES)
def test_a_cache_file_loads_in_the_other_package(writer, tmp_path):
    """A version-1 file saved by one package's ``save_cache`` loads in the
    other's with the same entries (each resolves only its own backend's)."""
    _, src = PACKAGES[writer]
    _, dst = PACKAGES["port" if writer == "reference" else "reference"]
    for kernel, n, width, br in (("murmur", 1 << 20, 1, 8), ("csr_gather_batched", 1 << 16, 4, 16)):
        _write_cache(tmp_path / f"{kernel}.json", src, kernel, n, width, br)
        src.load_cache(str(tmp_path / f"{kernel}.json"))
    saved = src.save_cache(str(tmp_path / "saved.json"))
    assert dst.load_cache(saved) == 2
    assert dst._cache == src._cache
    assert dst._details == src._details


def test_sweep_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        autotune.sweep_kernel("murmur", n=1024)
    with pytest.raises(RuntimeError, match="card"):
        autotune.autotune(sizes=(1024,))
    assert autotune._cache == {}


def test_plain_twins_ignore_block_rows():
    """On the CPU the wrappers take ``block_rows`` and run their twins as
    without it (the twins have no geometry)."""
    rng = np.random.default_rng(7)
    keys = torch.from_numpy(rng.integers(-2**31, 2**31, 700, dtype=np.int64).astype(np.int32))
    assert torch.equal(ops.hash_to_buckets(keys, 97, block_rows=3), ops.hash_to_buckets(keys, 97))
    bins = torch.from_numpy(rng.integers(0, 50, 999).astype(np.int32))
    assert torch.equal(ops.bin_histogram(bins, 50, block_rows=5), ops.bin_histogram(bins, 50))
    starts = torch.arange(64, dtype=torch.int32) * 4
    counts = torch.full((64,), 4, dtype=torch.int32)
    table = torch.from_numpy(rng.integers(0, 1 << 31, 256).astype(np.int32))
    for a, b in zip(ops.csr_gather(starts, counts, table, capacity=256, block_rows=1),
                    ops.csr_gather(starts, counts, table, capacity=256)):
        assert torch.equal(a, b)
    ends = starts + 4
    q = table[starts.long() + 1]
    assert torch.equal(ops.bucket_probe(table, starts, ends, q, block_rows=2),
                       ops.bucket_probe(table, starts, ends, q))


# ---------------------------------------------------------------------------
# the dry run over fake ranks
# ---------------------------------------------------------------------------
SMOKE = dataclasses.replace(get_smoke_config("qwen3_4b"), dtype="bfloat16")
MESH = ((2, 2), ("data", "model"))
TRAIN = ShapeCell("train_smoke", "train", 32, 8)
PREFILL = ShapeCell("prefill_smoke", "prefill", 32, 4)
DECODE = ShapeCell("decode_smoke", "decode", 64, 4)


@pytest.fixture(scope="module")
def dry():
    from repro_torch.launch import dryrun

    return {cell.kind: dryrun.trace_step(SMOKE, cell, *MESH, microbatches=2)
            for cell in (TRAIN, PREFILL, DECODE)}


def _sans_exchange(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if k != "exchange"}


def test_dry_run_collectives_are_the_designs(dry):
    from repro_torch.launch import lm_run, train_run

    (d, t), _ = MESH
    assert dry["train"]["microbatches"] == 2
    want = train_run.design_collectives(SMOKE, (d, t), "gspmd", TRAIN.seq_len,
                                        TRAIN.global_batch, 2, seq_parallel=True)
    assert _sans_exchange(dry["train"]["collective_op_counts"]) == want
    want = lm_run.design_collectives(SMOKE, (d, t), "prefill", PREFILL.seq_len,
                                     PREFILL.global_batch, PREFILL.seq_len)
    assert dry["prefill"]["collective_op_counts"] == want
    want = lm_run.design_collectives(SMOKE, (d, t), "decode", 1, DECODE.global_batch,
                                     DECODE.seq_len)
    assert dry["decode"]["collective_op_counts"] == want
    for rec in dry.values():
        assert rec["chips"] == 4 and rec["wire_bytes_per_rank"] > 0
        assert set(rec["wire_by_kind"]) == set(rec["collective_op_counts"])
        assert rec["memory_analysis"]["temp_size_in_bytes"] > 0


def test_dry_run_argument_bytes_are_the_specs(dry):
    from repro_torch.distributed import sharding
    from repro_torch.distributed.parallel import AbstractMesh
    from repro_torch.launch.mesh import production_parallel
    from repro_torch.models import transformer

    par = production_parallel(AbstractMesh(*MESH))
    for kind, dtype in (("train", torch.float32), ("prefill", torch.bfloat16),
                        ("decode", torch.bfloat16)):
        whole = transformer.Transformer(SMOKE, dtype=dtype, device="meta")
        want = sharding.shard_bytes_per_device(whole, sharding.param_pspecs(whole, par),
                                               dict(zip(MESH[1], MESH[0])))
        mem = dry[kind]["memory_analysis"]
        assert mem["param_bytes"] == want, kind
        assert mem["argument_size_in_bytes"] == (mem["param_bytes"] + mem["opt_state_bytes"]
                                                 + mem["input_bytes"] + mem["cache_bytes"])
    assert dry["train"]["memory_analysis"]["opt_state_bytes"] == \
        2 * dry["train"]["memory_analysis"]["param_bytes"]
    assert dry["decode"]["memory_analysis"]["cache_bytes"] > 0


def test_dry_run_prefill_flops_are_the_products_and_causal_pairs():
    """An unsharded prefill of B x S tokens: ``2 N`` FLOPs a token for the
    blocks' matrices (N without the tied embedding), the head on each
    sequence's last position, and kernel 6 at its causal pairs (4 hd a pair
    and query head), within 1e-3 relative."""
    from repro_torch.kernels import flash_attention
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer

    cfg = SMOKE
    rec = dryrun.trace_step(cfg, PREFILL, (1, 1), MESH[1])
    b, s = PREFILL.global_batch, PREFILL.seq_len
    whole = transformer.Transformer(cfg, dtype=torch.bfloat16, device="meta")
    blocks = sum(p.numel() for n, p in whole.named_parameters() if p.ndim >= 2 and n != "embed")
    pairs = flash_attention.live_pairs(s, s, causal=True, window=None)
    attention = 4.0 * b * cfg.num_heads * cfg.head_dim_ * pairs * cfg.num_layers
    want = 2.0 * blocks * b * s + 2.0 * cfg.d_model * cfg.vocab_size * b + attention
    assert rec["flops_per_rank"] == pytest.approx(want, rel=1e-3)
    assert rec["kernel_work"]["flash_attention"]["flops"] == pytest.approx(attention)
    assert rec["collective_op_counts"] == {} and rec["wire_bytes_per_rank"] == 0


def test_model_flops_equal_the_reference_for_every_arch_and_cell():
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model

    script = (
        "import json\n"
        "from repro.launch import dryrun\n"
        "from repro.configs.base import ARCH_IDS, SHAPE_SUITE, get_config\n"
        "from repro.distributed.parallel import single_device_parallel\n"
        "from repro.models.api import build_model\n"
        "out = {}\n"
        "for arch in ARCH_IDS:\n"
        "    cfg = get_config(arch)\n"
        "    shapes = build_model(cfg, single_device_parallel()).param_shapes()\n"
        "    for cell in SHAPE_SUITE:\n"
        "        out[arch + '.' + cell.name] = dryrun.model_flops(cfg, shapes, cell)\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    got = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    want = json.loads(got.stdout.strip().splitlines()[-1])
    assert len(want) == len(ARCH_IDS) * len(SHAPE_SUITE)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        whole = build_model(cfg, device="meta").param_shapes()
        for cell in SHAPE_SUITE:
            assert dryrun.model_flops(cfg, whole, cell) == want[f"{arch}.{cell.name}"], \
                (arch, cell.name)


def test_dry_run_cli_skips_what_the_config_refuses(tmp_path, capsys):
    """A cell ``supports_cell`` refuses is written ``skipped``; a written
    cell is not run again."""
    from repro_torch.launch import dryrun

    assert dryrun.main(["--arch", "qwen3_4b", "--cell", "long_500k", "--mesh", "both",
                        "--out", str(tmp_path)]) == 0
    for tag in ("single", "multi"):
        rec = json.loads((tmp_path / f"qwen3_4b.long_500k.{tag}.json").read_text())
        assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    assert dryrun.main(["--arch", "qwen3_4b", "--cell", "long_500k", "--mesh", "single",
                        "--out", str(tmp_path)]) == 0
    assert "cached" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------
def test_roofline_summary_roundtrip(tmp_path):
    """The reference's record, read with the H100's constants."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 50e9)
    rec = {
        "arch": "a", "cell": "train_4k", "multi_pod": False, "chips": 256,
        "status": "ok",
        "terms_s": {"compute_s": 0.5, "memory_s": 0.25, "collective_s": 0.1},
        "bottleneck": "compute_s",
        "model_flops_global": 0.5 * 256 * roofline.PEAK_FLOPS,
        "useful_flops_ratio": 1.0,
        "memory_analysis": {"temp_size_in_bytes": 2**30},
    }
    (tmp_path / "a.train_4k.single.json").write_text(json.dumps(rec))
    (tmp_path / "b.long_500k.single.json").write_text(json.dumps(
        {"arch": "b", "cell": "long_500k", "multi_pod": False, "status": "skipped",
         "reason": "full attention"}))
    rows = roofline.summarize(str(tmp_path))
    assert len(rows) == 1
    r = rows[0]
    assert r["fraction"] == pytest.approx(1.0)
    assert r["mfu"] == pytest.approx(1.0)
    assert r["bottleneck"] == "compute"
    assert r["temp_gib"] == pytest.approx(1.0) and r["mesh"] == "16x16"
    assert roofline.derive({"status": "skipped"}) is None
    table = roofline.markdown_table(rows)
    assert "| a | train_4k | 16x16 |" in table


def test_roofline_cli_prints_the_table(tmp_path, capsys):
    from repro_torch.launch import dryrun

    cell = SHAPE_SUITE[2]  # decode_32k
    rec = dryrun.trace_step(get_smoke_config("qwen3_4b"), cell, *MESH)
    rec.update(arch="qwen3_4b-smoke", cell=cell.name, multi_pod=False, status="ok")
    (tmp_path / "q.json").write_text(json.dumps(rec))
    roofline.main(["--dir", str(tmp_path), "--pick"])
    out = capsys.readouterr().out
    assert "9.890e+14 FLOP/s" in out and "| qwen3_4b-smoke | decode_32k | 16x16 |" in out
    assert "ok=1 skipped=0 error=0" in out

