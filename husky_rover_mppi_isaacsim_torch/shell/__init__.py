"""Host-side simulation shell (counterpart of the JAX ``shell``).

The reference wraps its sim loop in ROS1/ROS2 node managers whose jobs are
to expose a topic surface, queue stage edits for application between physics
steps, throttle to realtime and watch for shutdown. The port keeps that shell
as a dependency-free in-process pub/sub bus and monitor (copies of the JAX
package's, which import no jax) around the eager closed-loop step.
"""

from .monitor import ThreadMonitor
from .pubsub import MessageBus, Topics
from .rate import Rate
from .sim_manager import SimulationManager, SimulationManagerConf

__all__ = [
    "MessageBus",
    "Topics",
    "Rate",
    "ThreadMonitor",
    "SimulationManager",
    "SimulationManagerConf",
]
