"""Multi-process gangs and the multi-process check of the sharded training
step (counterpart of ``multimodal_fusion_tpu.parallel.multihost``).

``run_gang`` starts one process per rank of a ``torch.distributed`` world
on this machine (a file rendezvous in a fresh directory, so gangs never
race for a TCP port), runs a function in every rank and returns what each
returned.  A rank that fails or outlives the timeout fails the gang, with
its output, and no sibling is left running.  On the CPU the gang talks over
gloo; on a card a world of 1 runs NCCL, and larger gangs share the card
over gloo (NCCL refuses two ranks on one card).

``worker_main`` is the JAX module's check in port form: every rank runs
the flagship training step on its shard of a ``(replica=P, data=M)`` mesh
and holds the updated parameters against a local unsharded step (rtol
2e-4, as the JAX check), at dropout 0; at the flagship's dropout 0.25 the
ranks' parameters must be identical and the loss finite; then one slide's
sharded build statistics are held against the unsharded build.  Each
worker prints ``multihost OK proc i/P``.

Run it directly (spawns the gang itself)::

    python -m multimodal_fusion_tpu_torch.parallel.multihost --processes 2 --device cpu

or as the ranks of an external launch::

    torchrun --nproc_per_node 2 -m multimodal_fusion_tpu_torch.parallel.multihost --worker
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

_REPO = Path(__file__).resolve().parents[2]


def run_gang(target: str, world: int, kwargs: Optional[Dict[str, Any]] = None,
             timeout: float = 600.0, device: str = "cuda", threads: int = 1,
             workdir=None) -> Tuple[List[Any], List[str]]:
    """Run ``target`` ("module:function") in each of ``world`` ranks with
    ``kwargs``; returns (each rank's return value, each rank's output).
    ``device`` "cuda" (the default) puts the ranks on the card(s), "cpu"
    on the host.

    Raises RuntimeError with the failing rank's output when a rank exits
    non-zero or the gang outlives ``timeout`` seconds; every rank still
    running is killed first."""
    tmp = Path(tempfile.mkdtemp(prefix="gang_", dir=workdir))
    try:
        with open(tmp / "kwargs.pkl", "wb") as f:
            pickle.dump(kwargs or {}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(_REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
        procs, logs = [], []
        for rank in range(world):
            log = open(tmp / f"out_{rank}.txt", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "multimodal_fusion_tpu_torch.parallel.multihost",
                 "--gang_target", target, "--gang_dir", str(tmp), "--rank", str(rank),
                 "--processes", str(world), "--device", device, "--threads", str(threads),
                 "--timeout", str(timeout)],
                stdout=log, stderr=subprocess.STDOUT, env=dict(env, LOCAL_RANK=str(rank)),
                cwd=str(_REPO)))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            else:
                failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
        finally:
            for p in procs:  # a failed or hung rank must not leave its siblings running
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for log in logs:
                log.close()
        outputs = [(tmp / f"out_{r}.txt").read_text() for r in range(world)]
        if failed is None and any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"gang {target} x{world} timed out after {timeout:.0f} s:\n"
                               + "\n".join(o[-2000:] for o in outputs))
        if failed is not None:
            raise RuntimeError(f"gang {target} x{world}: rank {failed} failed:\n"
                               f"{outputs[failed][-6000:]}")
        results = []
        for rank in range(world):
            with open(tmp / f"result_{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))  # written by the ranks above
        return results, outputs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _gang_rank(target: str, gang_dir: str, rank: int, world: int, device: str, threads: int,
               timeout: float) -> None:
    """One rank of ``run_gang``: join the world, run the target, write its
    return value."""
    import torch
    import torch.distributed as dist

    from multimodal_fusion_tpu_torch.parallel.mesh import default_backend, rank_device

    torch.set_num_threads(threads)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(default_backend(dev, world), init_method=f"file://{gang_dir}/rendezvous",
                            rank=rank, world_size=world, timeout=timedelta(seconds=timeout))
    try:
        with open(Path(gang_dir) / "kwargs.pkl", "rb") as f:
            kwargs = pickle.load(f)  # written by run_gang
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(**kwargs)
        with open(Path(gang_dir) / f"result_{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def worker_main(local_devices: int = 1, rtol: float = 2e-4, device: str = "cuda") -> Dict:
    """The gang check of one rank (module docstring) on a (replica=P,
    data=local_devices) mesh over the world's P * local_devices ranks."""
    import torch.distributed as dist

    from multimodal_fusion_tpu_torch.parallel import dryrun
    from multimodal_fusion_tpu_torch.parallel.mesh import make_mesh_2d

    world = dist.get_world_size()
    mesh = make_mesh_2d(world // local_devices, local_devices, device=device)
    step = dryrun.check_flagship_step(mesh, G=2 * world, dropout=0.0)
    if step["param_rel"] > rtol or step["loss_rel"] > rtol:
        raise AssertionError(f"proc {mesh.rank}: sharded != unsharded {step}")
    drop = dryrun.check_flagship_step(mesh, G=2 * world, dropout=0.25)
    if not (drop["ranks_equal"] and drop["finite"]):
        raise AssertionError(f"proc {mesh.rank}: dropout 0.25 step {drop}")
    build = dryrun.check_build(mesh, n_patches=16 * world)
    print(f"multihost OK proc {mesh.rank}/{world}: mesh (replica={mesh.shape[0]}, "
          f"data={mesh.shape[1]}), sharded==unsharded max rel {step['param_rel']:.2e}; "
          f"cross-process slide build stats match (max rel {build['stats_rel']:.2e})", flush=True)
    return {"step": step, "dropout_step": drop, "build": build}


def launch(num_processes: int = 2, local_devices: int = 1, timeout: float = 600.0,
           device: str = "cuda", workdir=None) -> str:
    """Start a gang of ``num_processes * local_devices`` ranks running
    ``worker_main`` and check that each reports success; returns the
    combined output."""
    world = num_processes * local_devices
    _, outputs = run_gang("multimodal_fusion_tpu_torch.parallel.multihost:worker_main", world,
                          {"local_devices": local_devices, "device": device}, timeout=timeout,
                          device=device, workdir=workdir)
    for rank, out in enumerate(outputs):
        if f"multihost OK proc {rank}/{world}" not in out:
            raise RuntimeError(f"worker {rank} produced no OK line:\n{out[-3000:]}")
    return "\n".join(outputs)


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--local_devices", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--worker", action="store_true",
                   help="run worker_main as one rank of an external launch (torchrun)")
    # one rank of run_gang
    p.add_argument("--gang_target", type=str, default=None, help=argparse.SUPPRESS)
    p.add_argument("--gang_dir", type=str, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--threads", type=int, default=1, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.gang_target:
        _gang_rank(args.gang_target, args.gang_dir, args.rank, args.processes, args.device,
                   args.threads, args.timeout)
    elif args.worker:
        from multimodal_fusion_tpu_torch.parallel.mesh import init_world

        init_world(args.device)
        worker_main(args.local_devices, device=args.device)
    else:
        print(launch(args.processes, args.local_devices, args.timeout, args.device))


if __name__ == "__main__":
    main()
