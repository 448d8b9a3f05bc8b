"""Host-side scene graph: nodes, typed components, events.

The port's copy of stratum_tpu/scene/graph.py (numpy only; the breadth-first
walk takes a deque, so a graph of thousands of nodes walks in linear time),
so that the port builds scenes without importing the JAX package.

TPU-native analog of the reference engine's ECS-lite
(src/Node/NodeGraph.hpp: NodeGraph/Node/component_ptr/Event). The graph is a
pure host construct — it never touches the device. ``flatten`` (scene/flatten
.py) walks it once per change and produces the device ``SceneData``; this
mirrors the reference where ``Scene::update`` (Node/Scene.cpp:299-684)
re-flattens the node graph into GPU buffers when dirty.

Kept deliberately small: nodes own at most one component per type
(NodeGraph.hpp:243-262 enforces the same), parent/child edges, ancestor
transform accumulation (Scene.cpp:108-117 ``node_to_world``), BFS queries, and
priority-sorted events for frame-loop hooks (NodeGraph.hpp:166-202).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Any, Callable, Iterator, Optional, Type, TypeVar

import numpy as np

T = TypeVar("T")


class EventPriority(enum.IntEnum):
    """Listener ordering (reference: Node/NodeGraph.hpp EventPriority)."""

    FIRST = 0
    ALMOST_FIRST = 16
    DEFAULT = 32
    ALMOST_LAST = 48
    LAST = 64


class Event:
    """Priority-sorted multicast event. Listeners are (node, fn, priority);
    dead-node listeners are dropped at dispatch, matching the liveness check
    in NodeGraph.hpp:355-360."""

    def __init__(self) -> None:
        self._listeners: list[tuple["Node", Callable, int]] = []

    def add(self, node: "Node", fn: Callable, priority: int = EventPriority.DEFAULT):
        self._listeners.append((node, fn, int(priority)))
        self._listeners.sort(key=lambda e: e[2])

    def __call__(self, *args, **kwargs):
        self._listeners = [e for e in self._listeners if e[0].alive]
        for _, fn, _ in list(self._listeners):
            fn(*args, **kwargs)


class Node:
    def __init__(self, graph: "NodeGraph", name: str):
        self.graph = graph
        self.name = name
        self.parent: Optional[Node] = None
        self.children: list[Node] = []
        self.components: dict[type, Any] = {}
        self.alive = True

    # -- hierarchy ---------------------------------------------------------
    def add_child(self, name: str) -> "Node":
        child = Node(self.graph, name)
        child.parent = self
        self.children.append(child)
        return child

    def erase(self, recurse: bool = True):
        """Remove this node; children are reparented unless ``recurse``
        (reference: erase vs erase_recurse, NodeGraph.hpp:91-104)."""
        for c in list(self.children):
            if recurse:
                c.erase(True)
            else:
                c.parent = self.parent
                if self.parent is not None:
                    self.parent.children.append(c)
        self.children.clear()
        if self.parent is not None:
            self.parent.children.remove(self)
        self.alive = False

    # -- components --------------------------------------------------------
    def make_component(self, component: T) -> T:
        t = type(component)
        if t in self.components:
            raise ValueError(f"node {self.name!r} already has a {t.__name__}")
        self.components[t] = component
        if hasattr(component, "node"):
            component.node = self
        return component

    def find(self, t: Type[T]) -> Optional[T]:
        return self.components.get(t)

    def find_in_ancestor(self, t: Type[T]) -> Optional[T]:
        n: Optional[Node] = self
        while n is not None:
            c = n.components.get(t)
            if c is not None:
                return c
            n = n.parent
        return None

    def descendants(self) -> Iterator["Node"]:
        """BFS over the subtree including self (NodeGraph.hpp:275-344)."""
        queue = collections.deque([self])
        while queue:
            n = queue.popleft()
            yield n
            queue.extend(n.children)

    def find_in_descendants(self, t: Type[T]) -> Iterator[tuple["Node", T]]:
        for n in self.descendants():
            c = n.components.get(t)
            if c is not None:
                yield n, c

    # -- transforms --------------------------------------------------------
    def to_world(self, time: float | None = None) -> np.ndarray:
        """Accumulated ancestor transform, host-side 3x4 float32
        (reference: Scene::node_to_world, Node/Scene.cpp:108-117). With
        ``time`` given, AnimationComponents on the chain evaluate at that
        time and override the static TransformComponent."""
        m = np.eye(3, 4, dtype=np.float32)
        n: Optional[Node] = self
        while n is not None:
            ac = n.components.get(AnimationComponent) if time is not None else None
            if ac is not None:
                m = _compose_np(ac.evaluate(time), m)
            else:
                tc = n.components.get(TransformComponent)
                if tc is not None:
                    m = _compose_np(tc.matrix, m)
            n = n.parent
        return m


class NodeGraph:
    def __init__(self) -> None:
        self.root = Node(self, "root")
        # frame-loop events (reference: Application.hpp:13-16 PreFrame /
        # OnUpdate / OnRenderWindow / PostFrame)
        self.pre_frame = Event()
        self.on_update = Event()
        self.on_render = Event()
        self.post_frame = Event()


def _compose_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a o b) for host 3x4 affines."""
    out = np.empty((3, 4), np.float32)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out


# ---------------------------------------------------------------------------
# standard components
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TransformComponent:
    """Local 3x4 affine (reference: TransformData component on nodes)."""

    matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(3, 4, dtype=np.float32)
    )
    node: Optional[Node] = None


@dataclasses.dataclass
class AnimationComponent:
    """Keyframed local transform (reference: the animation tick that
    updates gAnimatedTransform each frame, Node/Scene.cpp:302-311).
    Linear interpolation between 3x4 keyframe matrices; flatten(time=t)
    evaluates it and also derives per-instance MOTION transforms for the
    temporal G-buffer (Scene.cpp:398-427 motion transforms)."""

    times: np.ndarray = None  # [K] seconds, ascending
    matrices: np.ndarray = None  # [K, 3, 4]
    node: Optional[Node] = None

    def evaluate(self, t: float) -> np.ndarray:
        times = np.asarray(self.times, np.float32)
        mats = np.asarray(self.matrices, np.float32)
        if t <= times[0]:
            return mats[0]
        if t >= times[-1]:
            return mats[-1]
        i = int(np.searchsorted(times, t) - 1)
        a = (t - times[i]) / max(times[i + 1] - times[i], 1e-9)
        return ((1.0 - a) * mats[i] + a * mats[i + 1]).astype(np.float32)


@dataclasses.dataclass
class MeshPrimitive:
    """Triangle mesh + material reference
    (reference: Scene.hpp MeshPrimitive)."""

    positions: np.ndarray  # [V,3] f32 object space
    indices: np.ndarray  # [T,3] i32
    normals: Optional[np.ndarray] = None  # [V,3]
    uvs: Optional[np.ndarray] = None  # [V,2]
    material: Optional[Any] = None  # host Material (scene/material.py)
    node: Optional[Node] = None


@dataclasses.dataclass
class SpherePrimitive:
    """Sphere primitive (reference: Scene.hpp SpherePrimitive). With
    ``analytic=True`` the sphere is traced exactly (quadratic hits +
    first-class sphere lights, reference intersection.hlsli:105-117,
    light.hlsli:58-121); otherwise it is tessellated to ``stacks x slices``
    triangles at flatten time."""

    radius: float = 1.0
    material: Optional[Any] = None
    stacks: int = 32
    slices: int = 64
    analytic: bool = False
    node: Optional[Node] = None


@dataclasses.dataclass
class CameraComponent:
    """Perspective camera (reference: Scene.hpp Camera)."""

    fovy: float = np.radians(70.0)
    near: float = 0.001
    node: Optional[Node] = None


@dataclasses.dataclass
class MediumComponent:
    """Heterogeneous participating medium in an axis-aligned world box
    (reference: host Medium w/ NanoVDB grids, Node/Material.hpp:72-94;
    loaders/load_volumes.cpp). ``density`` is sigma_t on a dense grid."""

    density: np.ndarray  # [Dz, Dy, Dx] float32 extinction
    box_lo: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    box_hi: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    albedo: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    g: float = 0.0
    node: Optional[Node] = None


@dataclasses.dataclass
class EnvironmentComponent:
    """Environment emission: constant color and/or equirect image
    (reference: Environment material, Shaders/environment.h)."""

    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    image: Optional[np.ndarray] = None  # [H,W,3] linear radiance
    source_path: Optional[str] = None  # asset file the image came from;
    # enables the <file>.dists.npz sampling-table disk cache
    # (reference: load_environment, environment.h:99-144)
    node: Optional[Node] = None
