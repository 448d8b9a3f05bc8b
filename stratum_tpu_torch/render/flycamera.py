"""FlyCamera controller: WASD + mouse-look camera state (counterpart of
stratum_tpu/render/flycamera.py, numpy only). Each update integrates
key-held motion in camera space, applies mouse-drag rotation with the
pitch clamped to (-pi/2, pi/2), scales the speed by scroll steps, and
writes the node's local TransformComponent. The input state arrives as
plain values, so scripted camera paths and tests drive it
deterministically; a windowing front end would feed it real events.

Conventions match core/transform.look_at: camera-to-world with +z forward,
+y up (world), +x right.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_PITCH_LIMIT = np.pi / 2 - 1e-3


@dataclasses.dataclass
class FlyCamera:
    """Camera pose + motion state. Attach to a node holding a
    TransformComponent and call update() once per frame."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    yaw: float = 0.0  # radians about world +y; 0 looks down +z
    pitch: float = 0.0  # radians; positive looks up
    speed: float = 1.0  # units/second
    rotate_rate: float = 0.002  # radians per mouse-delta unit
    speed_scale: float = 1.1  # per scroll step (reference: *= 1.1)
    node: object = None

    # key bindings (reference: W/A/S/D + Q/E for down/up)
    _MOVES = {
        "w": (0.0, 0.0, 1.0),
        "s": (0.0, 0.0, -1.0),
        "a": (-1.0, 0.0, 0.0),
        "d": (1.0, 0.0, 0.0),
        "q": (0.0, -1.0, 0.0),
        "e": (0.0, 1.0, 0.0),
    }

    def basis(self) -> np.ndarray:
        """3x3 camera-to-world rotation from (yaw, pitch): columns =
        (right, up, forward), identical to core/transform.look_at for the
        same forward direction and world up (0,1,0)."""
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        fwd = np.asarray([sy * cp, sp, cy * cp], np.float32)
        right = np.asarray([cy, 0.0, -sy], np.float32)
        up = np.cross(fwd, right).astype(np.float32)
        return np.stack([right, up, fwd], axis=-1)

    def update(self, dt: float, keys=(), mouse_delta=(0.0, 0.0), scroll=0.0,
               rotating: bool = True):
        """Advance the camera: ``keys`` is an iterable of held key names,
        ``mouse_delta`` the cursor delta in pixels (applied only while
        ``rotating``, the reference's right-button drag), ``scroll`` the
        wheel steps since the last update. Returns the camera-to-world
        3x4 matrix and (if attached) writes the node transform."""
        if scroll:
            self.speed *= float(self.speed_scale) ** float(scroll)
        if rotating:
            self.yaw += self.rotate_rate * float(mouse_delta[0])
            self.pitch = float(
                np.clip(
                    self.pitch - self.rotate_rate * float(mouse_delta[1]),
                    -_PITCH_LIMIT, _PITCH_LIMIT,
                )
            )
        move = np.zeros(3, np.float32)
        for k in keys:
            move += np.asarray(self._MOVES.get(str(k).lower(), (0, 0, 0)),
                               np.float32)
        basis = self.basis()
        if np.any(move):
            norm = move / max(np.linalg.norm(move), 1e-9)
            self.position = (
                self.position + basis @ norm * (self.speed * dt)
            ).astype(np.float32)
        c2w = np.concatenate(
            [basis, self.position[:, None]], axis=-1
        ).astype(np.float32)
        if self.node is not None:
            from stratum_tpu_torch.scene.graph import TransformComponent

            tc = self.node.find(TransformComponent)
            if tc is None:
                tc = self.node.make_component(TransformComponent())
            tc.matrix = c2w
        return c2w
