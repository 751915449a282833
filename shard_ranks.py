"""Run the port's sharded steps in one process per rank on this host, and
collect what each rank returns: the harness of ``chip_smoke.py``'s
``sharded_step`` phase and of ``tests/test_torch_parallel.py``.

    python shard_ranks.py <job file> <rank>

:func:`run_ranks` saves a job (the world, the controller state, the full
noise and a list of cases) with ``torch.save``, starts this script once per
rank (a fresh interpreter, never a fork: CUDA does not survive one), waits
for all of them with a deadline, and returns each rank's results. The ranks
meet through a ``FileStore`` in the job's directory, with the job's backend:
gloo on the CPU or for several ranks on one card, NCCL for one rank per card.

A rank builds its own mesh and shards for each case, runs it and records its
share of the outputs on the CPU, with the K1 launches the case made:

* ``{"kind": "sample", "config": MPPIConfig}``: ``parallel.sharded_mppi_step``
  on a 1-D ``("sample",)`` mesh of every rank;
* ``{"kind": "multi_rover", "config": MPPIConfig, "mesh": (r, s)}``:
  ``parallel.sharded_multi_rover_step`` on the job's N-rover state
  (``goals``, ``robots``, ``ctrls``, ``rover_noise``);
* ``{"kind": "sweep", "config": MPPIConfig, "counts": [...], "iters": n,
  "report": path}``: ``parallel.scaling_sweep``, then rank 0 writes
  ``parallel.write_scaling_report`` to ``report``.
"""

from __future__ import annotations

import datetime
import subprocess
import sys
import time
from pathlib import Path

import torch


def _run_case(case: dict, job: dict, device: torch.device) -> dict:
    from husky_rover_mppi_isaacsim_torch import parallel
    from husky_rover_mppi_isaacsim_torch.core.heightfield import HeightField
    from husky_rover_mppi_isaacsim_torch.mppi.critics import Costmap
    from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda
    from husky_rover_mppi_isaacsim_torch.parallel.mesh import _tree_map

    to = lambda tree: _tree_map(lambda t: t.to(device), tree)  # noqa: E731
    hf, cm = HeightField(*to(job["hf"])), Costmap(*to(job["costmap"]))
    world = torch.distributed.get_world_size()
    before = rollout_25d_cuda.launches
    if case["kind"] == "sample":
        mesh = parallel.make_mesh((world,), ("sample",), device)
        goal, robot, ctrl = parallel.replicate(mesh, to((job["goal"], job["robot"],
                                                         job["ctrl"])))
        noise = parallel.shard_samples(mesh, job["noise"].to(device))
        out = parallel.sharded_mppi_step(case["config"], mesh, hf, cm, goal, robot, ctrl, noise)
    elif case["kind"] == "multi_rover":
        mesh = parallel.rover_sample_mesh(*case["mesh"], device=device)
        goals, robots, ctrls, noise = parallel.shard_rovers(mesh, to(
            (job["goals"], job["robots"], job["ctrls"], job["rover_noise"])))
        out = parallel.sharded_multi_rover_step(case["config"], mesh, hf, cm, goals, robots,
                                                ctrls, parallel.shard_samples(mesh, noise))
    elif case["kind"] == "sweep":
        results = parallel.scaling_sweep(case["config"], hf, cm, case["counts"],
                                         iters=case["iters"], dtype=hf.z.dtype, device=device)
        report = None
        if torch.distributed.get_rank() == 0:
            report = parallel.write_scaling_report(case["report"], results, case["config"],
                                                   note=case.get("note", ""), device=device)
        return {"results": results, "report": report}
    else:
        raise ValueError(f"unknown case kind {case['kind']!r}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    cpu = lambda tree: _tree_map(lambda t: t.detach().cpu(), tree)  # noqa: E731
    return {"ctrl": cpu(out[0]), "out": cpu(out[1]),
            "k1_launches": rollout_25d_cuda.launches - before}


def rank_main(job_path: str, rank: int) -> None:
    """One rank: join the group, run every case of the job, save the
    results to ``<job>.rank<r>.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)  # written by run_ranks
    device = torch.device(job["device"])
    if device.type == "cuda":
        from husky_rover_mppi_isaacsim_torch.cli import use_full_fp32_matmul

        use_full_fp32_matmul()
    dist.init_process_group(job["backend"], init_method=f"file://{job['store']}",
                            world_size=job["world_size"], rank=rank,
                            timeout=datetime.timedelta(seconds=job["timeout_s"]))
    try:
        results = [_run_case(case, job, device) for case in job["cases"]]
        torch.save(results, f"{job_path}.rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(job: dict, world_size: int, workdir, backend: str = "gloo", device="cpu",
              timeout_s: float = 300.0) -> list[list[dict]]:
    """Run ``job`` on ``world_size`` rank processes on ``device`` (every
    rank on the same device) and return each rank's list of case results.
    Raises if a rank fails or the deadline passes; every rank process has
    ended when this returns."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    store.unlink(missing_ok=True)
    job_path = workdir / "job.pt"
    torch.save({**job, "store": str(store), "world_size": world_size, "backend": backend,
                "device": str(device), "timeout_s": timeout_s}, job_path)
    logs = [workdir / f"rank{r}.log" for r in range(world_size)]
    procs = []
    try:
        for r in range(world_size):
            with open(logs[r], "w") as log:  # the child holds its own descriptor
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), str(job_path), str(r)],
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError("rank(s) {} failed:\n{}".format(failed, "\n".join(
            f"--- rank {r} ---\n{logs[r].read_text()[-4000:]}" for r in failed)))
    return [torch.load(f"{job_path}.rank{r}.pt", weights_only=False)
            for r in range(world_size)]


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]))
