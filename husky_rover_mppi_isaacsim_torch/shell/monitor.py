"""Failure detection: liveness monitor with registered shutdown hooks.

Re-design of ``ThreadMonitor``
(src/terrain_management/large_scale_terrain/high_resolution_DEM_workers.py:
768-835): a daemon thread polls (1) main-thread liveness, (2) an external
"simulation alive" probe, (3) a SIGINT flag, every ``poll_s`` seconds, and
on any failure fires every registered shutdown callback exactly once (the
reference uses these to poison-pill its worker pools and drain queues).

A copy of ``husky_rover_mppi_isaacsim_tpu/shell/monitor.py``, which imports no jax:
the port carries its own rather than import the JAX package.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, List, Optional


class ThreadMonitor:
    """Watchdog thread with idempotent shutdown fan-out."""

    def __init__(
        self,
        poll_s: float = 1.0,
        sim_alive: Optional[Callable[[], bool]] = None,
        install_sigint: bool = False,
    ):
        self.poll_s = poll_s
        self._sim_alive = sim_alive
        self._shutdowns: List[Callable[[], None]] = []
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._sigint = threading.Event()
        self._main = threading.main_thread()
        self._thread: Optional[threading.Thread] = None
        self._prev_handler = None
        if install_sigint:
            self._prev_handler = signal.getsignal(signal.SIGINT)
            signal.signal(signal.SIGINT, self._on_sigint)

    def _on_sigint(self, signum, frame):
        self._sigint.set()

    def register_shutdown(self, fn: Callable[[], None]) -> None:
        self._shutdowns.append(fn)

    @property
    def is_alive(self) -> bool:
        """Checked each sim tick (simulation_manager_ros2.py:235-247)."""
        return not self._fired.is_set()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="thread-monitor", daemon=True
        )
        self._thread.start()

    def _should_shutdown(self) -> bool:
        if self._sigint.is_set():
            return True
        if not self._main.is_alive():
            return True
        if self._sim_alive is not None and not self._sim_alive():
            return True
        return False

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self._should_shutdown():
                self.fire()
                return

    def fire(self) -> None:
        """Run shutdown hooks exactly once (idempotent, any caller)."""
        if self._fired.is_set():
            return
        self._fired.set()
        for fn in self._shutdowns:
            try:
                fn()
            except Exception:  # shutdown must not cascade
                pass

    def stop(self, run_shutdowns: bool = False) -> None:
        """Stop polling; optionally run the shutdown hooks (clean exit path,
        SimulationApp_wait.close joins registered threads)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s * 3)
        if self._prev_handler is not None:
            # restore Ctrl-C: a stopped monitor no longer polls the flag,
            # so keeping our handler would swallow SIGINT forever
            try:
                if signal.getsignal(signal.SIGINT) == self._on_sigint:
                    signal.signal(signal.SIGINT, self._prev_handler)
            except ValueError:
                pass  # not the main thread — leave the handler in place
            self._prev_handler = None
        if run_shutdowns:
            self.fire()
