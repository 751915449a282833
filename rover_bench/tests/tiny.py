"""Tiny sizes of every cell for the CPU tests: the widths and shapes of
the cells, cut to what a CPU run does in seconds."""

TINY = {
    "thesis_k1000.goal_seek": {
        "config": {"mppi": {"num_samples": 16, "horizon": 8},
                   "world": {"grid_size": 150, "costmap_size": 75}},
        "traffic": {"max_loops": 40, "check": {"replays": 3}}},
    "thesis_k1000.fleet64": {
        "config": {"mppi": {"num_samples": 16, "horizon": 8},
                   "world": {"grid_size": 150, "costmap_size": 75}},
        "traffic": {"rovers": 3, "check": {"steps": 3}}},
}


def run_tiny(workload: str, seconds: float = 0.5, seed: int = 2 ** 31 + 12345, **kw):
    """One run of a cell at its tiny size on the CPU."""
    import time

    from rover_bench.harness import runner

    return runner.run(workload, seed, seconds, False, time.perf_counter(), allow_cpu=True,
                      overrides=TINY[workload], **kw)
