"""Shard groups across processes (the table's counterpart of
``repro.launch.mesh``).

:func:`init_shard_group` joins this process to a ``torch.distributed``
group, as ``torchrun`` starts it (``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``) or through a
``file://`` store, and returns the ``exchange.ProcessGroup`` a
``DistributedHashTable(group=...)`` takes: one shard per rank.

:func:`spawn` runs a function on ``world`` fresh processes joined that way
and returns what each rank returned; it bounds every wait, so a rank that
fails or hangs fails the call instead of the caller.

Several cards, one rank a card (NCCL)::

    torchrun --nproc-per-node=K -m repro_torch.launch.mesh --keys 16777216

runs the read part of ``table_run.run_slice`` over the K ranks (a table of
``--keys`` uint32 keys; query, contains, join_size, plan_caps, retrieve,
inner_join and their auto retries of the rank's block of the queries),
checks sampled rows against a numpy oracle and prints each rank's device
and wall per entry point.  Each rank runs on its card; without one it
stops, unless ``--device cpu`` asks for the plain path.  NCCL refuses two
ranks on one card; ``--backend gloo --device cuda:0`` runs several ranks on
one card, with every exchange staged through host memory.

The reference's language-model meshes are here too:
:func:`make_production_mesh` and :func:`make_smoke_mesh` are
``torch.distributed`` ``DeviceMesh``es over the group and
:func:`production_parallel` wires a ``ParallelConfig`` to one
(``launch/lm_run.py`` serves a model over them).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import exchange

DEFAULT_TIMEOUT_S = 120.0
ORACLE_SAMPLES = 4096  # query rows a rank holds against numpy in ``main``


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def init_shard_group(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    *,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    device=None,
) -> exchange.ProcessGroup:
    """Join the default process group and return it as a shard group.

    ``rank`` / ``world_size`` default to ``RANK`` / ``WORLD_SIZE`` (as
    ``torchrun`` sets them); ``init_method`` to ``env://`` (``MASTER_ADDR``
    / ``MASTER_PORT``), or pass a ``file://`` store.  ``backend=None``
    takes NCCL when the rank's device is a CUDA card and gloo otherwise.
    ``device`` (a CUDA device, or ``"cpu"``) pins the rank's card;
    ``None`` takes card ``LOCAL_RANK`` and raises ``RuntimeError`` where
    there is no card: the CPU runs only when the caller asks.  The group
    always has a finite ``timeout_s``, so ranks that issue different
    collectives fail instead of waiting for ever.
    """
    import torch.distributed as dist

    rank = _env_int("RANK", 0) if rank is None else int(rank)
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else int(world_size)
    local_rank = _env_int("LOCAL_RANK", rank)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a shard group's rank runs on its CUDA card by default and none is "
                "available; pass device='cpu' for the plain path"
            )
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(
            backend,
            init_method=init_method or "env://",
            rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=float(timeout_s)),
        )
    return exchange.ProcessGroup(timeout_s=timeout_s)


def _rank_main(fn, rank, world, backend, device, init_method, timeout_s, args, results):
    """A spawned rank: join the group, run ``fn(group, *args)``, report."""
    try:
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        group = init_shard_group(backend, init_method, timeout_s, rank=rank,
                                 world_size=world, device=device)
        out = fn(group, *args)
        results.put((rank, True, out))
    except Exception:  # noqa: BLE001 - every failure goes to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 - the result is already sent
                pass


def spawn(
    fn: Callable,
    world: int,
    backend: Optional[str] = None,
    device=None,
    args: Sequence = (),
    timeout_s: float = DEFAULT_TIMEOUT_S,
    store_dir: Optional[str] = None,
) -> list:
    """Run ``fn(group, *args)`` on ``world`` spawned ranks; return the ranks'
    results in rank order.

    Every rank joins through a fresh ``file://`` store in ``store_dir`` (a
    new temporary directory by default), on ``device``: ``None`` gives rank
    ``r`` card ``r`` (modulo the cards) and raises ``RuntimeError`` where
    there is no card; a named card puts every rank on it; ``"cpu"`` runs
    the plain path with one thread a rank.  ``backend=None`` is NCCL on
    cards and gloo on the CPU (:func:`init_shard_group`).  ``fn`` and its results must
    pickle (a module-level function; numpy arrays and plain values back).
    The group's timeout is ``timeout_s``; the parent waits at most a little
    longer for all results, and when a rank fails or the wait runs out it
    kills every rank still running and raises ``RuntimeError`` with the
    failing ranks' tracebacks.
    """
    import multiprocessing as mp

    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "spawned ranks run on CUDA cards by default and none is available; "
            "pass device='cpu' for the plain path"
        )
    device = None if device is None else str(device)
    ctx = mp.get_context("spawn")
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="shard_group_") if own_dir else store_dir
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.monotonic_ns()}")
    init_method = "file://" + store
    results = ctx.Queue()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(fn, r, world, backend, device, init_method, timeout_s, tuple(args), results),
            daemon=True,
        )
        for r in range(world)
    ]
    for p in procs:
        p.start()
    got, errors = {}, {}
    deadline = time.monotonic() + timeout_s + 60.0
    try:
        while len(got) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got and r not in errors]
                # A rank that died without reporting (killed, crashed in C).
                for r in dead:
                    if procs[r].exitcode not in (0, None):
                        errors[r] = f"rank {r} exited with code {procs[r].exitcode}"
                continue
            (got if ok else errors)[rank] = out
            if not ok:
                break  # the others would wait for it until the timeout
    finally:
        if errors or len(got) < world:
            for p in procs:
                if p.is_alive():
                    p.kill()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        results.close()
        if own_dir:
            for name in os.listdir(store_dir):
                try:
                    os.remove(os.path.join(store_dir, name))
                except OSError:
                    pass
            try:
                os.rmdir(store_dir)
            except OSError:
                pass
    if errors or len(got) < world:
        missing = [r for r in range(world) if r not in got and r not in errors]
        msg = "".join(f"\n--- rank {r} ---\n{tb}" for r, tb in sorted(errors.items()))
        if missing and errors:
            msg += f"\nranks {missing} were stopped after the failure"
        elif missing:
            msg += f"\nranks {missing} did not report within {timeout_s + 60.0:.0f} s"
        raise RuntimeError(f"spawned shard group of {world} failed:{msg}")
    return [got[r] for r in range(world)]


def device_mesh(shape: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` with axis ``names`` over the whole
    process group (its ranks row-major); raises ``ValueError`` when the
    group's size differs.  Its device type follows the backend (NCCL: cuda,
    gloo: cpu): the mesh only lays out ranks, the groups the models use are
    made by ``distributed.collectives.bind``."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs a group of {math.prod(shape)} "
                         f"ranks; this one has {world}")
    backend = str(dist.get_backend()).lower() if dist.is_initialized() else "gloo"
    return init_device_mesh("cuda" if backend == "nccl" else "cpu", tuple(shape),
                            mesh_dim_names=tuple(names))


def production_mesh_shape(multi_pod: bool = False) -> tuple:
    """``(shape, axis names)`` of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: one pod is ``("data", "model") = (16, 16)``;
    multi-pod ``("pod", "data", "model") = (2, 16, 16)``, the ``pod`` axis
    composing with ``data`` for DP/FSDP.  Needs a group of 256 (512) ranks."""
    return device_mesh(*production_mesh_shape(multi_pod))


def smoke_mesh_shape(n: int) -> tuple:
    """``(shape, axis names)`` of the reference's small mesh over n devices."""
    if n >= 4:
        return (n // 2, 2), ("data", "model")
    return (n,), ("data",)


def make_smoke_mesh(devices: Optional[int] = None):
    """A small mesh over the group: ``(n // 2, 2)`` for n >= 4 ranks, else
    ``(n,)``; n defaults to the group's size."""
    import torch.distributed as dist

    n = devices or (dist.get_world_size() if dist.is_initialized() else 1)
    return device_mesh(*smoke_mesh_shape(n))


def production_parallel(
    mesh,
    *,
    moe_impl: str = "ep",
    microbatches: int = 8,
    grad_compression: bool = False,
    seq_parallel: bool = True,
    act_barrier: bool = False,
):
    """ParallelConfig wired for the mesh's axes: ``pod`` and ``data`` are the
    dp axes, ``model`` the tp axis.  ``seq_parallel`` defaults on: the
    residual stream is sequence-sharded over ``model``, turning each
    layer's activation all-reduces into reduce-scatter / all-gather pairs."""
    from repro_torch.distributed.parallel import ParallelConfig, mesh_shape

    names = tuple(mesh_shape(mesh))
    dp_axes = tuple(a for a in names if a in ("pod", "data"))
    tp_axis = "model" if "model" in names else None
    return ParallelConfig(
        mesh=mesh,
        dp_axes=dp_axes,
        tp_axis=tp_axis,
        moe_impl=moe_impl,
        microbatches=microbatches,
        remat=True,
        grad_compression=grad_compression,
        seq_parallel=seq_parallel,
        act_barrier=act_barrier,
    )


# ---------------------------------------------------------------------------
# torchrun entry point: the read pass of table_run, walls per rank
# ---------------------------------------------------------------------------


def run_reads(group: exchange.ProcessGroup, n_keys: int, seed: int = 0, device=None,
              queries: Optional[int] = None) -> dict:
    """This rank's part of the base's read pass (``table_run.run_slice`` with
    ``versioned=False``) at ``n_keys`` keys and ``queries`` queries (global
    counts; default ``n_keys / 4``), on ``device`` (``None``: the rank's
    card), checked against the numpy oracle on sampled rows.  Returns the
    rank's device, its wall in seconds, exchange rounds (apart: the plan's
    counts rounds) and reductions per entry point, and the oracle's tally; raises ``AssertionError`` when the
    oracle disagrees or rows were dropped."""
    from repro_torch.launch import table_run

    cfg = table_run.SliceConfig(n_keys=n_keys, seed=seed, queries=queries)
    sink = table_run.Sink()
    run = table_run.run_slice(cfg, sink, group=group, device=device, keep_state=True,
                              versioned=False)
    r, d = group.rank, group.size
    oracle = table_run.sampled_oracle(run["data"], seed, d, r, sink.blocks, ORACLE_SAMPLES)
    dropped = {k: v for k, v in sink.scalars.items() if k.endswith("num_dropped") and v}
    if oracle["bad"] or dropped:
        raise AssertionError(f"rank {r}: {oracle['bad']} of {oracle['rows']} sampled rows "
                             f"differ from the oracle; dropped {dropped}")
    dev = run["device"]
    steps = run["steps"]
    return {"rank": r, "world": d, "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "walls_s": {k: v["wall_s"] for k, v in steps.items()},
            "rounds": {k: v["rounds"] for k, v in steps.items()},
            "plan_rounds": {k: v["plan_rounds"] for k, v in steps.items()},
            "reductions": {k: v["collectives"] for k, v in steps.items()},
            "oracle": oracle}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--keys", type=int, default=1 << 24, help="global key count")
    parser.add_argument("--queries", type=int, default=None,
                        help="global query batch (default keys / 4)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backend", default=None, help="nccl (default on a card) or gloo")
    parser.add_argument("--device", default=None,
                        help="the rank's device (default: card LOCAL_RANK; 'cpu' for the "
                             "plain path)")
    parser.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    args = parser.parse_args(argv)
    group = init_shard_group(args.backend, timeout_s=args.timeout, device=args.device)
    device = torch.device(args.device) if args.device else \
        torch.device("cuda", torch.cuda.current_device())
    try:
        out = run_reads(group, args.keys, args.seed, device, args.queries)
        print(json.dumps({"backend": group.backend, "keys": args.keys, **out}), flush=True)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
