"""In-process typed message bus (copy of activesplat_tpu/runtime/bus.py).

Replacement for ROS1 TCPROS between the reference's two nodes
(SURVEY.md section 5 'distributed communication'): same service/topic *names*
and payload shapes, but synchronous in-process dispatch — the planner's
blocking get_topdown/get_opacity semantics (visualizer.py:2155-2221) become
plain function calls that render fresh state on demand, removing the
Condition-variable rendezvous entirely.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class ServiceError(RuntimeError):
    pass


class Bus:
    def __init__(self) -> None:
        self._services: Dict[str, Callable[..., Any]] = {}
        self._topics: Dict[str, List[Callable[[Any], None]]] = {}
        self._last_message: Dict[str, Any] = {}

    # services ---------------------------------------------------------- #

    def register_service(self, name: str, fn: Callable[..., Any]) -> None:
        if name in self._services:
            raise ValueError(f"service {name!r} already registered")
        self._services[name] = fn

    def call(self, name: str, *args, **kwargs) -> Any:
        if name not in self._services:
            raise ServiceError(f"service {name!r} not registered")
        return self._services[name](*args, **kwargs)

    def has_service(self, name: str) -> bool:
        return name in self._services

    # topics ------------------------------------------------------------- #

    def subscribe(self, topic: str, fn: Callable[[Any], None]) -> None:
        self._topics.setdefault(topic, []).append(fn)

    def publish(self, topic: str, message: Any) -> None:
        self._last_message[topic] = message
        for fn in self._topics.get(topic, []):
            fn(message)

    def last_message(self, topic: str, default: Any = None) -> Any:
        return self._last_message.get(topic, default)


# The reference's channel list (SURVEY.md section 5), kept as the canonical
# name registry so launch configs and logs remain recognizable.
SERVICES = (
    "get_dataset_config",
    "reset_env",
    "get_topdown_config",
    "get_topdown",
    "get_opacity",
    "set_mapper",
    "set_planner_state",
    "get_voronoi_graph",
    "get_navigation_path",
)
TOPICS = (
    "cmd_vel",
    "camera_pose",  # reference legacy name: orb_slam3/camera_pose
    "movement_fail_times",
    "high_loss_samples_pose",
    "frames",
    "update_voronoi_graph_vis",
    "update_high_connectivity_nodes_vis",
    "update_global_visibility_map_vis",
)
