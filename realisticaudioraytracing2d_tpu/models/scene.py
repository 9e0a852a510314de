"""Scene representation and builders.

The reference flattens Unity ``Collider2D`` components into an edge-soup
``List<Segment>`` (``Assets/Script/Helpers/SceneHelper.cs:29-98``). This
rebuild keeps the same *data contract* — each wall is a segment with start,
end, outward normal and an acoustic material — but stores it as a
struct-of-arrays pytree (:class:`Scene`) with static, padded wall counts so
every scene size maps to a small set of compiled shapes.

Builders mirror the reference's collider flattening semantics exactly:

* box -> 4-corner loop from size/offset (``SceneHelper.cs:49-57``),
* polygon paths -> per-path loops (``SceneHelper.cs:41-47``),
* circle -> 32-segment tessellation (``SceneHelper.cs:59-68``),
* loop edges get transform applied per point and a winding-signed outward
  normal ``(dir.y, -dir.x) * sign(scale.x * scale.y)``
  (``SceneHelper.cs:78-98``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .materials import AudioMaterial

CIRCLE_RESOLUTION = 32  # SceneHelper.cs:26


@dataclass(frozen=True)
class Transform2D:
    """Position + rotation + scale, the 2D restriction of a Unity transform.

    ``transform_point`` reproduces ``Transform.TransformPoint`` for the 2D
    case: world = position + R(angle) @ (scale * p).
    """

    position: Tuple[float, float] = (0.0, 0.0)
    angle: float = 0.0  # radians, counter-clockwise
    scale: Tuple[float, float] = (1.0, 1.0)

    def transform_point(self, p: np.ndarray) -> np.ndarray:
        c, s = math.cos(self.angle), math.sin(self.angle)
        x = p[..., 0] * self.scale[0]
        y = p[..., 1] * self.scale[1]
        return np.stack(
            [c * x - s * y + self.position[0],
             s * x + c * y + self.position[1]], axis=-1)

    @property
    def winding(self) -> float:
        """Normal-flip sign for mirrored scales (``SceneHelper.cs:80-81``)."""
        return math.copysign(1.0, self.scale[0] * self.scale[1])


class Scene(NamedTuple):
    """Struct-of-arrays edge soup. All fields are float32 jnp arrays except
    ``mask`` (bool). ``W`` is the (padded) wall count, ``K`` the band count.

    Padding walls are degenerate (a == b) so the intersection math returns
    INF for them without extra masking in the hot loop; ``mask`` exists for
    host-side bookkeeping and viz.
    """

    a: jax.Array            # [W, 2] segment start
    b: jax.Array            # [W, 2] segment end
    normal: jax.Array       # [W, 2] outward normal (winding-signed)
    absorption: jax.Array   # [W, K]
    scattering: jax.Array   # [W]
    transmission: jax.Array  # [W]
    ior: jax.Array          # [W]
    mask: jax.Array         # [W] bool: True = real wall

    @property
    def n_walls(self) -> int:
        return self.a.shape[-2]

    @property
    def n_bands(self) -> int:
        return self.absorption.shape[-1]

    @property
    def n_valid(self) -> jax.Array:
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)

    def pad_to(self, n: int) -> "Scene":
        """Pad the wall axis to ``n`` with inert degenerate segments."""
        w = self.n_walls
        if n < w:
            raise ValueError(f"pad_to({n}) smaller than wall count {w}")
        if n == w:
            return self
        pad = n - w

        def pad_field(x, fill=0.0):
            # wall axis: -2 for [W, 2] fields, -1 for [W] fields
            axis = x.ndim - 2 if x.ndim >= 2 else x.ndim - 1
            cfg = [(0, 0)] * x.ndim
            cfg[axis] = (0, pad)
            return jnp.pad(x, cfg, constant_values=fill)

        return Scene(
            a=pad_field(self.a), b=pad_field(self.b),
            normal=pad_field(self.normal),
            absorption=jnp.pad(self.absorption, [(0, pad), (0, 0)],
                               constant_values=1.0),
            scattering=pad_field(self.scattering),
            transmission=pad_field(self.transmission),
            ior=jnp.pad(self.ior, [(0, pad)], constant_values=1.0),
            mask=jnp.pad(self.mask, [(0, pad)], constant_values=False),
        )

    def concat(self, other: "Scene",
               pad_to: Optional[int] = None) -> "Scene":
        """Merge two edge soups — the host-side builder op behind dynamic
        obstacles (static room + per-chunk moving geometry; the reference
        re-flattens colliders every FixedUpdate, RayTraceManager.cs:67).
        Valid walls are compacted to the front, then padded to ``pad_to``
        (default: the sum of both padded sizes, so repeated per-chunk
        merges keep one compiled shape). Host-side only (data-dependent
        compaction); band counts must match."""
        if self.n_bands != other.n_bands:
            raise ValueError(
                f"band mismatch: {self.n_bands} vs {other.n_bands}")
        m1 = np.asarray(self.mask)
        m2 = np.asarray(other.mask)

        def cat(x1, x2):
            return jnp.asarray(np.concatenate(
                [np.asarray(x1)[m1], np.asarray(x2)[m2]], axis=0))

        merged = Scene(a=cat(self.a, other.a), b=cat(self.b, other.b),
                       normal=cat(self.normal, other.normal),
                       absorption=cat(self.absorption, other.absorption),
                       scattering=cat(self.scattering, other.scattering),
                       transmission=cat(self.transmission,
                                        other.transmission),
                       ior=cat(self.ior, other.ior),
                       mask=cat(self.mask, other.mask))
        return merged.pad_to(pad_to if pad_to is not None
                             else self.n_walls + other.n_walls)

    @staticmethod
    def stack(scenes: Sequence["Scene"]) -> "Scene":
        """Batch scenes along a leading axis (they must share W and K);
        used for room-dataset sweeps (vmap/shard_map over axis 0)."""
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *scenes)


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def loop_segments(points: np.ndarray, transform: Transform2D):
    """Flatten one closed loop of local-space points under a transform
    into ``(starts, ends, normals)`` world-space arrays — the
    ``SceneHelper.cs:78-98`` semantics, factored out so a collider can
    be re-flattened in place (live geometry steering,
    :meth:`SceneBuilder.move_collider`)."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2 or len(pts) < 2:
        raise ValueError("loop needs [N>=2, 2] points")
    winding = transform.winding
    world = transform.transform_point(pts)
    starts = world
    ends = np.roll(world, -1, axis=0)
    d = ends - starts
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    dirv = np.where(norm > 0, d / np.where(norm > 0, norm, 1.0), 0.0)
    normals = np.stack([dirv[:, 1], -dirv[:, 0]], axis=-1) * winding
    return starts, ends, normals


@dataclass(frozen=True)
class ColliderRecord:
    """One builder collider: its recipe (local loops + material +
    authored transform) and its wall span in the flattened scene — what
    live geometry steering needs to re-flatten it under a new transform
    without touching any other wall (the reference re-reads obstacle
    transforms and re-flattens every FixedUpdate,
    ``RayTraceManager.cs:67,246-250`` -> ``SceneHelper.cs:29-76``)."""

    name: Optional[str]
    kind: str                    # box / circle / polygon / loop / segment
    material: AudioMaterial
    transform: Transform2D
    loops: Optional[Tuple[np.ndarray, ...]]  # local points; None = raw seg
    start: int                   # first wall row
    count: int                   # wall rows


class SceneBuilder:
    """Host-side accumulation of wall segments, then one device upload.

    The flattening mirrors ``SceneToData2D.GetSegmentsFromColliders``
    (``SceneHelper.cs:29-76``): each collider contributes a closed loop of
    segments with its resolved material. Each ``add_*`` call is recorded
    as a :class:`ColliderRecord` (optionally named) so a built scene's
    colliders can be re-posed in place later
    (:meth:`move_collider` — live geometry steering)."""

    def __init__(self, n_bands: int = 1):
        self.n_bands = int(n_bands)
        self._starts: List[np.ndarray] = []
        self._ends: List[np.ndarray] = []
        self._normals: List[np.ndarray] = []
        self._mats: List[AudioMaterial] = []
        self.colliders: List[ColliderRecord] = []

    # -- loop flattening (SceneHelper.cs:78-98 semantics) ------------------
    def _flatten_loop(self, points: np.ndarray, material: AudioMaterial,
                      transform: Transform2D) -> None:
        starts, ends, normals = loop_segments(points, transform)
        for p1, p2, nrm in zip(starts, ends, normals):
            self._starts.append(p1)
            self._ends.append(p2)
            self._normals.append(nrm)
            self._mats.append(material)

    def _record(self, name, kind, material, transform, loops,
                start: int) -> None:
        self.colliders.append(ColliderRecord(
            name=name, kind=kind, material=material, transform=transform,
            loops=(tuple(np.asarray(p, np.float64) for p in loops)
                   if loops is not None else None),
            start=start, count=len(self._starts) - start))

    def add_loop(self, points: np.ndarray, material: AudioMaterial,
                 transform: Transform2D = Transform2D(),
                 name: Optional[str] = None) -> "SceneBuilder":
        pts = np.asarray(points, dtype=np.float64)
        start = len(self._starts)
        self._flatten_loop(pts, material, transform)
        self._record(name, "loop", material, transform, [pts], start)
        return self

    def add_box(self, material: AudioMaterial,
                transform: Transform2D = Transform2D(),
                size: Tuple[float, float] = (1.0, 1.0),
                offset: Tuple[float, float] = (0.0, 0.0),
                name: Optional[str] = None) -> "SceneBuilder":
        """BoxCollider2D flattening (``SceneHelper.cs:49-57``): 4-corner loop
        (-h,-h) (h,-h) (h,h) (-h,h) around ``offset`` in local space."""
        hx, hy = size[0] * 0.5, size[1] * 0.5
        ox, oy = offset
        corners = np.array([[ox - hx, oy - hy], [ox + hx, oy - hy],
                            [ox + hx, oy + hy], [ox - hx, oy + hy]])
        start = len(self._starts)
        self._flatten_loop(corners, material, transform)
        self._record(name, "box", material, transform, [corners], start)
        return self

    def add_circle(self, material: AudioMaterial,
                   transform: Transform2D = Transform2D(),
                   radius: float = 0.5,
                   offset: Tuple[float, float] = (0.0, 0.0),
                   resolution: int = CIRCLE_RESOLUTION,
                   name: Optional[str] = None) -> "SceneBuilder":
        """CircleCollider2D flattening (``SceneHelper.cs:59-68``)."""
        ang = np.arange(resolution) / resolution * 2.0 * np.pi
        pts = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * radius
        pts = pts + np.asarray(offset)
        start = len(self._starts)
        self._flatten_loop(pts, material, transform)
        self._record(name, "circle", material, transform, [pts], start)
        return self

    def add_polygon(self, paths: Sequence[np.ndarray],
                    material: AudioMaterial,
                    transform: Transform2D = Transform2D(),
                    name: Optional[str] = None) -> "SceneBuilder":
        """PolygonCollider2D flattening: one loop per path
        (``SceneHelper.cs:41-47``)."""
        start = len(self._starts)
        paths = [np.asarray(p, np.float64) for p in paths]
        for path in paths:
            self._flatten_loop(path, material, transform)
        self._record(name, "polygon", material, transform, paths, start)
        return self

    def add_segment(self, start, end, normal, material: AudioMaterial,
                    name: Optional[str] = None) -> "SceneBuilder":
        """Raw segment escape hatch (explicit normal, no winding logic;
        not steerable — it has no transform to re-pose)."""
        row = len(self._starts)
        self._starts.append(np.asarray(start, dtype=np.float64))
        self._ends.append(np.asarray(end, dtype=np.float64))
        self._normals.append(np.asarray(normal, dtype=np.float64))
        self._mats.append(material)
        self._record(name, "segment", material, Transform2D(), None, row)
        return self

    # -- live geometry steering ---------------------------------------------
    def find_collider(self, obstacle) -> ColliderRecord:
        """Resolve a collider by name (str) or build-order index (int);
        raises ``KeyError`` naming the known colliders."""
        if isinstance(obstacle, str):
            for c in self.colliders:
                if c.name == obstacle:
                    return c
            known = [c.name for c in self.colliders if c.name is not None]
            raise KeyError(
                f"unknown obstacle {obstacle!r}; named colliders: {known}"
                + ("" if known else " (none named; use an index "
                   f"0..{len(self.colliders) - 1})"))
        idx = int(obstacle)
        if not 0 <= idx < len(self.colliders):
            raise KeyError(f"obstacle index {idx} out of range "
                           f"(0..{len(self.colliders) - 1})")
        return self.colliders[idx]

    def move_collider(self, scene: Scene, obstacle,
                      position=None, angle=None) -> Scene:
        """Re-flatten ONE collider of a built scene under a new
        position/angle (scale and shape unchanged — the wall count
        cannot change, so the padded scene keeps its compiled shape and
        per-chunk moves recompile nothing). Unspecified fields fall back
        to the authored transform. Returns a new :class:`Scene`; the
        builder record is NOT mutated (overrides are absolute, matching
        the pose feed's hold semantics). This is the per-FixedUpdate
        re-flatten of the reference's dynamic obstacles
        (``RayTraceManager.cs:67`` -> ``SceneHelper.cs:29-76``),
        restricted to the collider that actually moved."""
        c = self.find_collider(obstacle)
        if c.loops is None:
            raise ValueError(
                f"collider {obstacle!r} is a raw segment (no transform); "
                "not steerable")
        tf = Transform2D(
            position=(tuple(float(v) for v in position)
                      if position is not None else c.transform.position),
            angle=(float(angle) if angle is not None
                   else c.transform.angle),
            scale=c.transform.scale)
        starts, ends, normals = [], [], []
        for pts in c.loops:
            s, e, nm = loop_segments(pts, tf)
            starts.append(s)
            ends.append(e)
            normals.append(nm)
        a = np.concatenate(starts).astype(np.float32)
        b = np.concatenate(ends).astype(np.float32)
        nrm = np.concatenate(normals).astype(np.float32)
        rows = jnp.arange(c.start, c.start + c.count)
        return scene._replace(
            a=scene.a.at[rows].set(jnp.asarray(a)),
            b=scene.b.at[rows].set(jnp.asarray(b)),
            normal=scene.normal.at[rows].set(jnp.asarray(nrm)))

    # -- finalize -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._starts)

    def build(self, pad_to: Optional[int] = None,
              pad_multiple: int = 8) -> Scene:
        """Produce the device Scene. Walls are padded to ``pad_to`` if given,
        else to the next multiple of ``pad_multiple`` (shape bucketing to
        keep the jit cache small across dynamic-obstacle updates)."""
        n = len(self._starts)
        if n == 0:
            raise ValueError("empty scene")
        total = pad_to if pad_to is not None else round_up(n, pad_multiple)
        if total < n:
            raise ValueError(f"pad_to={pad_to} < wall count {n}")

        k = self.n_bands
        a = np.zeros((total, 2), np.float32)
        b = np.zeros((total, 2), np.float32)
        nrm = np.zeros((total, 2), np.float32)
        absb = np.ones((total, k), np.float32)
        scat = np.zeros((total,), np.float32)
        trans = np.zeros((total,), np.float32)
        ior = np.ones((total,), np.float32)
        mask = np.zeros((total,), bool)

        a[:n] = np.asarray(self._starts, np.float32)
        b[:n] = np.asarray(self._ends, np.float32)
        nrm[:n] = np.asarray(self._normals, np.float32)
        for i, m in enumerate(self._mats):
            absb[i] = m.absorption_bands(k)
            scat[i] = m.scattering
            trans[i] = m.transmission
            ior[i] = m.ior
        mask[:n] = True

        return Scene(a=jnp.asarray(a), b=jnp.asarray(b),
                     normal=jnp.asarray(nrm), absorption=jnp.asarray(absb),
                     scattering=jnp.asarray(scat),
                     transmission=jnp.asarray(trans), ior=jnp.asarray(ior),
                     mask=jnp.asarray(mask))


def scene_from_boxes(boxes: Sequence[Tuple[Transform2D, AudioMaterial]],
                     n_bands: int = 1, pad_to: Optional[int] = None) -> Scene:
    """Convenience: a scene made of unit boxes under per-box transforms —
    exactly how the reference rooms are authored (unit BoxCollider2D scaled
    and rotated by the GameObject transform, see SmollRoom.unity)."""
    builder = SceneBuilder(n_bands=n_bands)
    for tf, mat in boxes:
        builder.add_box(mat, tf)
    return builder.build(pad_to=pad_to)
