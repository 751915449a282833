"""In-process pub/sub message bus — the ROS-topic surface without ROS.

Replaces the DDS layer the reference uses for robot I/O and scene
interaction (``src/environments_wrappers/ros2/*``; topic catalogue in
``wiki/scene_interaction/ros_topics.md``). Topic names mirror the
reference's so a user of the original stack finds the same surface:

* robot control:  ``/OmniLRS/Robots/{Spawn,Teleport,Reset,ResetAll}``
* sun control:    ``/OmniLRS/Sun/{Intensity,Pose,Color}``
* rendering:      ``/OmniLRS/Render/{EnableRTXRealTime,EnableRTXInteractive}``
  and LensFlare/ChromaticAberration/MotionBlur setter topics.

Handlers run synchronously on publish (single-process determinism); the
convention that stage edits only *enqueue* work for between-step application
is preserved by the subscribers themselves (they call
``RobotManager.enqueue``-style APIs, exactly like the ROS callbacks append
to ``modifications`` — base_wrapper_ros2.py:78-92).

A copy of ``husky_rover_mppi_isaacsim_tpu/shell/pubsub.py``, which imports no jax:
the port carries its own rather than import the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List


class Topics:
    """The reference's topic names (ros_topics.md)."""

    ROBOT_SPAWN = "/OmniLRS/Robots/Spawn"
    ROBOT_TELEPORT = "/OmniLRS/Robots/Teleport"
    ROBOT_RESET = "/OmniLRS/Robots/Reset"
    ROBOT_RESET_ALL = "/OmniLRS/Robots/ResetAll"
    SUN_INTENSITY = "/OmniLRS/Sun/Intensity"
    SUN_POSE = "/OmniLRS/Sun/Pose"
    RENDER_RTX_REALTIME = "/OmniLRS/Render/EnableRTXRealTime"
    RENDER_RTX_INTERACTIVE = "/OmniLRS/Render/EnableRTXInteractive"
    LENS_FLARE_ENABLE = "/OmniLRS/LensFlare/EnableLensFlares"
    MOTION_BLUR_ENABLE = "/OmniLRS/MotionBlur/Enable"
    POSE_STATE = "/OmniLRS/Robots/PoseState"       # published each tick


class MessageBus:
    """Synchronous topic bus: subscribe callbacks, publish dict payloads."""

    def __init__(self):
        self._subs: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)
        self._latched: Dict[str, Any] = {}

    def subscribe(self, topic: str, callback: Callable[[Any], None]) -> None:
        self._subs[topic].append(callback)
        if topic in self._latched:
            callback(self._latched[topic])

    def publish(self, topic: str, message: Any = None, latch: bool = False) -> int:
        """Deliver to all subscribers; returns delivery count. ``latch``
        replays the last message to late subscribers (ROS latched topics)."""
        if latch:
            self._latched[topic] = message
        handlers = list(self._subs.get(topic, ()))
        for fn in handlers:
            fn(message)
        return len(handlers)

    def topics(self) -> List[str]:
        return sorted(self._subs)

    def has_subscribers(self, topic: str) -> bool:
        """Publishers with expensive payloads (device fetches) guard on
        this to skip materialization when nobody listens."""
        return bool(self._subs.get(topic))
