"""Realtime rate throttle — re-derivation of the ``Rate`` helper the
reference uses to pace its sim loop to wall-clock
(src/environments_wrappers/ros2/simulation_manager_ros2.py:31-76: sleep the
remainder of the period, tracking overshoot so slow ticks borrow from fast
ones).

A copy of ``husky_rover_mppi_isaacsim_tpu/shell/rate.py``, which imports no jax:
the port carries its own rather than import the JAX package.
"""

from __future__ import annotations

import time


class Rate:
    """Sleep so successive :meth:`sleep` calls average ``1/hz`` seconds."""

    def __init__(self, hz: float, clock=time.monotonic, sleeper=time.sleep):
        if hz <= 0:
            raise ValueError("rate must be positive")
        self.period = 1.0 / float(hz)
        self._clock = clock
        self._sleep = sleeper
        self._next = clock() + self.period
        self.overruns = 0

    def reset(self) -> None:
        self._next = self._clock() + self.period
        self.overruns = 0

    def sleep(self) -> float:
        """Block until the next tick boundary; returns the slack (s) that
        was slept (negative when the loop overran the period)."""
        now = self._clock()
        slack = self._next - now
        if slack >= 0:  # exactly on the boundary is on time, not an overrun
            if slack > 0:
                self._sleep(slack)
        else:
            self.overruns += 1
            # Re-anchor instead of bursting to catch up (matches the
            # reference's behaviour of never running faster than realtime).
            self._next = now
        self._next += self.period
        return slack
