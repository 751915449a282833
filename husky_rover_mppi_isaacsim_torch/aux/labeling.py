"""Synthetic data generation (SDG): labels rendered straight from the
simulation state (counterpart of the JAX ``aux/labeling.py``, which replaces
the replicator/annotator pipeline of ``src/labeling/``, auto_label.py:174-239
+ rep_utils.py writers).

* ``hillshade``   the Lambertian sun-lit DEM (RGB proxy), optionally with
  cast shadows marched toward the sun;
* ``depth``       the orthographic height map;
* ``semantic``    class ids rasterized from rock footprints;
* ``instance``    per-rock instance ids;
* ``normals``     the surface normal map;
* a robot-mounted perspective pass: per-pixel rays marched against the DEM
  with rocks as sphere impostors (depth / rgb / semantic / instance).

Everything is torch on the DEM's device; the JAX package's ``lax.scan``s
over march steps and rocks are Python loops over device tensors with no
host sync inside. A recorder given a rock capacity
(:class:`AutonomousLabeling`, as ``cli.run_sdg`` makes it) runs each frame
as two CUDA graphs on the card, the JAX package's compiled passes: the
top-down pass (:func:`top_down_pass`) and the camera pass
(:func:`camera_pass`), with the frame's rocks padded to the capacity and
masked (:func:`pad_rocks`), so that one graph serves every frame. The rock
rasters are computed in float64 (the rock draws are float64 numpy), as the
JAX package computes them with 64-bit floats enabled. The writer saves
``.npy`` always and a PNG of each 2-D modality where PIL imports.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import time

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..core.graphs import Graphed
from ..terrain.upsample import bilinear_point_sample
from .render_fx import apply_post_fx


@dataclasses.dataclass
class LabelingConf:
    """auto_label.py AutonomousLabelingConf essentials."""

    num_images: int = 100
    prim_path: str = "/World"
    save_rgb: bool = True
    save_depth: bool = True
    save_semantics: bool = True
    save_instances: bool = False
    save_normals: bool = False
    data_dir: str = "sdg_output"


def _scalar(v, like: Tensor) -> Tensor:
    """``v`` as a tensor of ``like``'s dtype and device: a division by it is
    a division (CUDA turns a division by a Python float into a multiply by
    its reciprocal). A number becomes a fill (no host-to-device copy, so a
    CUDA graph can capture it), a tensor is converted on its device, an
    array is uploaded."""
    if isinstance(v, Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    if isinstance(v, (int, float)):
        return torch.full((), float(v), dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(v), dtype=like.dtype, device=like.device)


def surface_normals(z: Tensor, resolution) -> Tensor:
    """(H, W, 3) unit normals from central differences."""
    two_res = 2 * _scalar(resolution, z)
    dzdx = (torch.roll(z, -1, 0) - torch.roll(z, 1, 0)) / two_res
    dzdy = (torch.roll(z, -1, 1) - torch.roll(z, 1, 1)) / two_res
    n = torch.stack([-dzdx, -dzdy, torch.ones_like(z)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def _unit(v, like: Tensor) -> Tensor:
    v = _scalar(v, like)
    return v / torch.linalg.vector_norm(v)


def hillshade(z: Tensor, resolution, sun_direction) -> Tensor:
    """Lambertian shaded relief of the DEM lit by ``sun_direction`` (3,),
    the RGB-proxy render product."""
    n = surface_normals(z, resolution)
    return torch.clamp((n * _unit(sun_direction, z)).sum(-1), 0.0, 1.0)


def cast_shadow_mask(z: Tensor, resolution, sun_direction, steps: int = 64) -> Tensor:
    """(H, W) shadow mask (1 = shadowed): each DEM cell marches toward the
    sun in ``steps`` fixed world-space steps (quadratically spaced out to
    the window's size) and tests terrain occlusion."""
    h, w = z.shape
    sun = _unit(sun_direction, z)
    res = _scalar(resolution, z)
    max_t = _scalar(float(max(h, w)), z) * res  # clears the window at grazing angles
    eps = res * 0.5
    rows = torch.arange(h, dtype=z.dtype, device=z.device)[:, None]
    cols = torch.arange(w, dtype=z.dtype, device=z.device)[None, :]
    ts = (torch.arange(1, steps + 1, dtype=z.dtype, device=z.device) / steps) ** 2 * max_t
    shadowed = torch.zeros_like(z, dtype=torch.bool)
    for i in range(steps):
        t = ts[i]
        px = rows + sun[0] * t / res
        py = cols + sun[1] * t / res
        ray_z = z + sun[2] * t + eps
        inside = (px >= 0) & (px <= h - 1) & (py >= 0) & (py <= w - 1)
        shadowed |= inside & (bilinear_point_sample(z, px, py) > ray_z)
    return shadowed.to(z.dtype)


def hillshade_shadowed(z: Tensor, resolution, sun_direction, shadow_steps: int = 64,
                       ambient: float = 0.15) -> Tensor:
    """:func:`hillshade` with cast shadows: shadowed cells fall to the
    ambient floor whatever their Lambertian term."""
    shade = hillshade(z, resolution, sun_direction)
    mask = cast_shadow_mask(z, resolution, sun_direction, steps=shadow_steps)
    return ambient + (1.0 - ambient) * shade * (1.0 - mask)


def _raster_axes(shape, resolution, origin, device):
    h, w = shape
    f64 = dict(dtype=torch.float64, device=device)
    return (torch.arange(h, **f64) * resolution + origin[0],
            torch.arange(w, **f64) * resolution + origin[1])


def _f64(v, device) -> Tensor:
    """Rock draws as float64 on ``device`` (a tensor is converted there)."""
    if isinstance(v, Tensor):
        return v.to(dtype=torch.float64, device=device)
    return torch.as_tensor(np.asarray(v, np.float64), device=device)


def _stamp_rocks(rows: Tensor, cols: Tensor, rock_xy, rock_radius, valid=None) -> Tensor:
    """Rock-disk rasterization, one rock at a time (O(H W) memory): 1-based
    rock ids, 0 where no rock; later rocks win ties. ``valid`` (bool per
    rock) leaves padded slots out: a zero radius would still cover the cell
    under its centre (``d2 <= 0``)."""
    rocks, radii = _f64(rock_xy, rows.device), _f64(rock_radius, rows.device)
    out = torch.zeros((rows.shape[0], cols.shape[0]), dtype=torch.int32, device=rows.device)
    for i in range(rocks.shape[0]):
        d2 = (rows[:, None] - rocks[i, 0]) ** 2 + (cols[None, :] - rocks[i, 1]) ** 2
        inside = d2 <= radii[i] * radii[i]
        if valid is not None:
            inside = inside & valid[i]
        out = torch.where(inside, i + 1, out)
    return out


def semantic_mask(shape: tuple, resolution: float, origin, rock_xy, rock_radius,
                  ground_id: int = 1, rock_id: int = 2, device=None, valid=None) -> Tensor:
    """Class-id raster (int32): ground everywhere, rocks stamped as disks
    (those ``valid`` keeps, where given)."""
    rows, cols = _raster_axes(shape, resolution, origin, device)
    seg = torch.full(tuple(shape), ground_id, dtype=torch.int32, device=device)
    if len(rock_xy) == 0:
        return seg
    return torch.where(_stamp_rocks(rows, cols, rock_xy, rock_radius, valid) > 0, rock_id, seg)


def instance_mask(shape: tuple, resolution: float, origin, rock_xy, rock_radius,
                  device=None, valid=None) -> Tensor:
    """Per-rock instance ids (int32, 1-based; 0 = background)."""
    if len(rock_xy) == 0:
        return torch.zeros(tuple(shape), dtype=torch.int32, device=device)
    return _stamp_rocks(*_raster_axes(shape, resolution, origin, device), rock_xy, rock_radius,
                        valid)


class PaddedRocks(NamedTuple):
    """A frame's rocks padded to a fixed capacity: float64 ``xy``
    ``(capacity, 2)`` and ``radius`` ``(capacity,)``, the live rocks first
    in their drawn order (so ids stay 1-based in that order), then zero
    slots that ``valid`` masks out."""

    xy: Tensor
    radius: Tensor
    valid: Tensor


def rock_capacity(density: float, area_m2: float) -> int:
    """Rock slots of one SDG frame: 1.5 x the expected count of the
    frame's Poisson draw (``density`` per m^2 over ``area_m2``) + 16,
    rounded up to 16 (the crater tiers' rule at rock scale). The hard-core
    thinning only removes rocks."""
    cap = int(area_m2 * density * 1.5) + 16
    return -(-cap // 16) * 16


def pad_rocks(rock_xy, rock_radius, capacity: int, device=None) -> PaddedRocks:
    """``rock_xy`` / ``rock_radius`` (``None`` for none) padded to
    ``capacity`` on ``device``. More rocks than the capacity raise: a frame
    never drops rocks."""
    xy = np.zeros((0, 2)) if rock_xy is None else np.asarray(rock_xy, np.float64).reshape(-1, 2)
    r = np.zeros((0,)) if rock_radius is None else np.asarray(rock_radius, np.float64)
    n = xy.shape[0]
    if n > capacity or r.shape != (n,):
        raise ValueError(f"{n} rocks (radii {r.shape}) for a rock capacity of {capacity}")
    pxy, pr = np.zeros((capacity, 2)), np.zeros((capacity,))
    pxy[:n], pr[:n] = xy, r
    valid = np.arange(capacity) < n
    return PaddedRocks(*(torch.as_tensor(a, device=device) for a in (pxy, pr, valid)))


@dataclasses.dataclass
class CameraIntrinsics:
    """Pinhole intrinsics (focal length + apertures, rep_utils.py:108-126),
    in fx/fy/cx/cy pixel form."""

    width: int = 640
    height: int = 480
    focal_length: float = 24.0           # mm
    horizontal_aperture: float = 20.955  # mm (USD default)
    vertical_aperture: float | None = None

    @property
    def fx(self) -> float:
        return self.width * self.focal_length / self.horizontal_aperture

    @property
    def fy(self) -> float:
        va = self.vertical_aperture
        if va is None:
            va = self.horizontal_aperture * self.height / self.width
        return self.height * self.focal_length / va

    @property
    def cx(self) -> float:
        return self.width / 2.0

    @property
    def cy(self) -> float:
        return self.height / 2.0

    def pinhole(self, like: Tensor) -> "Pinhole":
        """The pinhole with ``fx``, ``fy``, ``cx``, ``cy`` as 0-d tensors of
        ``like``'s dtype on its device: the camera graph's input."""
        return Pinhole(self.width, self.height,
                       *(_scalar(v, like) for v in (self.fx, self.fy, self.cx, self.cy)))

    def as_dict(self) -> dict:
        return {"width": self.width, "height": self.height, "focal_length": self.focal_length,
                "horizontal_aperture": self.horizontal_aperture,
                "fx": self.fx, "fy": self.fy, "cx": self.cx, "cy": self.cy}


class Pinhole(NamedTuple):
    """Image size and pinhole parameters (floats or 0-d tensors): what
    :func:`render_camera_frame` reads of a :class:`CameraIntrinsics`."""

    width: int
    height: int
    fx: object
    fy: object
    cx: object
    cy: object


def camera_pose_from_rover(rover_xy, heading_xy, ground_z, mount_height: float = 0.8,
                           pitch_deg: float = 15.0):
    """Robot-mounted camera pose (numpy): position ``mount_height`` above
    the rover, looking along the heading, pitched down. Returns
    ``(cam_pos (3,), R (3, 3))``, ``R``'s columns the camera's (right,
    down, forward) axes in the world frame (+z up)."""
    hx, hy = float(heading_xy[0]), float(heading_xy[1])
    n = float(np.hypot(hx, hy))
    if n < 1e-9:  # degenerate heading: +x (a zero vector would NaN the rotation)
        hx, hy, n = 1.0, 0.0, 1.0
    hx, hy = hx / n, hy / n
    p = np.deg2rad(pitch_deg)
    fwd = np.array([np.cos(p) * hx, np.cos(p) * hy, -np.sin(p)])
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    cam_pos = np.array([float(rover_xy[0]), float(rover_xy[1]), float(ground_z) + mount_height])
    return cam_pos, R


def _ray_directions(cam_R: Tensor, fx, fy, cx, cy, width: int, height: int) -> Tensor:
    """World-frame ray directions ``(height, width, 3)``, scaled so that the
    march parameter is the image-plane depth: R @ ((u - cx)/fx, (v - cy)/fy, 1)."""
    like = cam_R
    u = (torch.arange(width, dtype=like.dtype, device=like.device) - _scalar(cx, like)) \
        / _scalar(fx, like)
    v = (torch.arange(height, dtype=like.dtype, device=like.device) - _scalar(cy, like)) \
        / _scalar(fy, like)
    d_cam = torch.stack([u[None, :].expand(height, width), v[:, None].expand(height, width),
                         torch.ones((height, width), dtype=like.dtype, device=like.device)],
                        dim=-1)
    return torch.einsum("ij,hwj->hwi", cam_R, d_cam)


def camera_raycast(z: Tensor, resolution, origin, cam_pos, cam_R, fx, fy, cx, cy, *,
                   width: int, height: int, steps: int = 192, max_range: float = 40.0):
    """Perspective heightfield raycast: per-pixel rays marched against the
    DEM in ``steps`` fixed steps with linear hit refinement. ``z`` is
    indexed ``[row = x, col = y]`` at world position ``origin + index *
    resolution``.

    Returns ``(depth, hit_x, hit_y, hit_mask)``, each ``(height, width)``;
    ``depth`` is the distance to the image plane, ``inf`` where the ray
    leaves the window or passes ``max_range``."""
    h_px, w_px = z.shape
    res = _scalar(resolution, z)
    ox, oy = _scalar(origin[0], z), _scalar(origin[1], z)
    cam_pos = _scalar(cam_pos, z)
    d_world = _ray_directions(_scalar(cam_R, z), fx, fy, cx, cy, width, height)
    ss = torch.linspace(0.05, max_range, steps, dtype=torch.float64,
                        device=z.device).to(z.dtype)

    def clearance(s):
        p = cam_pos + d_world * s
        px = (p[..., 0] - ox) / res
        py = (p[..., 1] - oy) / res
        inside = (px >= 0) & (px <= h_px - 1) & (py >= 0) & (py <= w_px - 1)
        return torch.where(inside, p[..., 2] - bilinear_point_sample(z, px, py), float("inf"))

    prev_s, prev_c = ss[0], clearance(ss[0])
    hit_s = torch.full((height, width), float("inf"), dtype=z.dtype, device=z.device)
    hit_mask = prev_c <= 0.0
    for i in range(1, steps):
        s = ss[i]
        c = clearance(s)
        new_hit = ~hit_mask & torch.isfinite(c) & (c <= 0.0)
        # linear refinement between the bracketing samples
        denom = prev_c - c
        frac = torch.where(torch.abs(denom) > 1e-12, prev_c / denom, 1.0)
        s_ref = torch.where(torch.isfinite(prev_c),
                            prev_s + torch.clamp(frac, 0.0, 1.0) * (s - prev_s), s)
        hit_s = torch.where(new_hit, s_ref, hit_s)
        hit_mask = hit_mask | new_hit
        prev_s, prev_c = s, c
    hit_s = torch.where(hit_mask, hit_s, float("inf"))
    p = cam_pos + d_world * torch.where(hit_mask, hit_s, 0.0)[..., None]
    return hit_s, p[..., 0], p[..., 1], hit_mask


def _rock_intersections(cam_pos: Tensor, d_world: Tensor, centers: Tensor, radii: Tensor,
                        max_range: Tensor, valid: Tensor | None = None):
    """Nearest ray-sphere hit against half-buried rock impostors (spheres
    centred on the ground surface). ``d_world`` is the unscaled ray
    direction of :func:`camera_raycast`, so ``s`` is the same image-plane
    depth. Returns ``(s, rock_id)`` per pixel, ``inf`` / ``0`` where no rock
    is hit; one rock at a time (O(H W) memory). ``valid`` (bool per rock)
    leaves padded slots out: the discriminant of a zero radius can round
    above 0."""
    a = torch.sum(d_world * d_world, dim=-1)  # > 0
    best_s = torch.full(a.shape, float("inf"), dtype=a.dtype, device=a.device)
    best_id = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    for i in range(radii.shape[0]):
        oc = cam_pos - centers[i]
        b = 2.0 * torch.einsum("hwi,i->hw", d_world, oc)
        c0 = torch.dot(oc, oc) - radii[i] * radii[i]
        disc = b * b - 4.0 * a * c0
        s_hit = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
        hit = (disc > 0) & (s_hit > 0.05) & (s_hit <= max_range)
        if valid is not None:
            hit = hit & valid[i]
        s_hit = torch.where(hit, s_hit, float("inf"))
        better = s_hit < best_s
        best_s = torch.where(better, s_hit, best_s)
        best_id = torch.where(better, i + 1, best_id)
    return best_s, best_id


def render_camera_frame(z: Tensor, resolution: float, origin, cam_pos, cam_R,
                        intrinsics: CameraIntrinsics | Pinhole, sun_direction=(0.4, 0.2, 0.9),
                        rock_xy=None, rock_radius=None, steps: int = 192,
                        max_range: float = 40.0, cast_shadows: bool = False,
                        rock_valid: Tensor | None = None) -> dict:
    """Camera-frame modality dict (depth / rgb / semantic / instance / hit)
    from one raycast: the pose-consistent perspective pass
    (rep_utils.py:108-126 + auto_label.py:174-230). The pose, the
    intrinsics' pinhole and the sun may be tensors; ``rock_valid`` masks
    padded rock slots (:class:`PaddedRocks`)."""
    i = intrinsics
    depth, hx, hy, hit = camera_raycast(z, resolution, origin, cam_pos, cam_R, i.fx, i.fy,
                                        i.cx, i.cy, width=i.width, height=i.height,
                                        steps=steps, max_range=max_range)
    shade = (hillshade_shadowed if cast_shadows else hillshade)(z, resolution, sun_direction)
    res = _scalar(resolution, z)
    px = torch.clamp((hx - origin[0]) / res, 0, z.shape[0] - 1)
    py = torch.clamp((hy - origin[1]) / res, 0, z.shape[1] - 1)
    rgb = torch.where(hit, shade[px.to(torch.int32), py.to(torch.int32)], 0.0)
    if rock_xy is None or not len(rock_xy):
        semantic = torch.where(hit, 1, 0).to(torch.int32)
        return {"depth": depth, "rgb": rgb, "hit": hit, "semantic": semantic,
                "instance": torch.zeros_like(semantic)}
    # rocks occlude: sphere impostors centred on the ground surface compete
    # with the terrain march per ray
    rocks = _scalar(rock_xy, z)
    rx, ry, rr = rocks[:, 0], rocks[:, 1], _scalar(rock_radius, z)
    gz = bilinear_point_sample(z, (rx - origin[0]) / res, (ry - origin[1]) / res)
    centers = torch.stack([rx, ry, gz], dim=-1)
    d_world = _ray_directions(_scalar(cam_R, z), i.fx, i.fy, i.cx, i.cy, i.width, i.height)
    cam_p = _scalar(cam_pos, z)
    s_rock, rock_id = _rock_intersections(cam_p, d_world, centers, rr, _scalar(max_range, z),
                                          rock_valid)
    rock_hit = s_rock < depth  # wins where nearer than the terrain
    depth = torch.where(rock_hit, s_rock, depth)
    hit = hit | rock_hit
    # Lambertian sphere shading from the surface normal at the hit
    p_hit = cam_p + d_world * torch.where(rock_hit, s_rock, 0.0)[..., None]
    idx = torch.clamp(rock_id - 1, 0, rr.shape[0] - 1).to(torch.int64)
    n = (p_hit - centers[idx]) / rr[idx][..., None]
    rock_shade = torch.clamp(torch.einsum("hwi,i->hw", n, _unit(sun_direction, z)), 0.0, 1.0)
    rgb = torch.where(rock_hit, rock_shade, rgb)
    return {"depth": depth, "rgb": rgb, "hit": hit,
            "semantic": torch.where(rock_hit, 2, torch.where(hit, 1, 0)).to(torch.int32),
            "instance": torch.where(rock_hit, rock_id, 0).to(torch.int32)}


def top_down_pass(z: Tensor, resolution: float, origin, sun_direction, rocks,
                  conf: LabelingConf) -> dict:
    """The device work of one top-down frame, as :meth:`AutonomousLabeling.
    record` saves it before its post effects: the hillshade (``rgb``), the
    ``normals`` and the ``semantic`` and ``instance`` rock rasters, each
    where ``conf`` saves it.
    ``rocks`` is ``(xy, radius, valid)``: arrays with ``valid`` None, or a
    :class:`PaddedRocks`. The recorder's CUDA graph replays this function."""
    out = {}
    if conf.save_rgb:
        out["rgb"] = hillshade(z, resolution, sun_direction)
    if conf.save_normals:
        out["normals"] = surface_normals(z, resolution)
    xy, radii, valid = rocks
    if conf.save_semantics:
        out["semantic"] = semantic_mask(z.shape, resolution, origin, xy, radii, device=z.device,
                                        valid=valid)
    if conf.save_instances:
        out["instance"] = instance_mask(z.shape, resolution, origin, xy, radii, device=z.device,
                                        valid=valid)
    return out


def camera_pass(z: Tensor, resolution: float, origin, cam_pos, cam_R, intrinsics,
                sun_direction, rocks, steps: int, max_range: float, cast_shadows: bool) -> dict:
    """The device work of one camera frame: :func:`render_camera_frame`
    with ``rocks`` as in :func:`top_down_pass`; positional, so that the
    recorder's CUDA graph replays it."""
    xy, radii, valid = rocks
    return render_camera_frame(z, resolution, origin, cam_pos, cam_R, intrinsics,
                               sun_direction=sun_direction, rock_xy=xy, rock_radius=radii,
                               steps=steps, max_range=max_range, cast_shadows=cast_shadows,
                               rock_valid=valid)


def _host(t: Tensor) -> np.ndarray:
    return t.cpu().numpy()


class AutonomousLabeling:
    """Frame recorder (auto_label.py:232-239 ``record`` loop): each
    ``record`` renders the enabled modalities from the terrain and rocks
    and writes them to the hashed run directory. ``seconds`` sums the time
    spent rendering the top-down and the camera passes (each up to its
    arrays on the host) and writing.

    With a ``rock_capacity`` every frame's rocks are padded to it
    (:func:`pad_rocks`; more raise) and the two passes run as
    :class:`..core.graphs.Graphed` functions, CUDA graphs on the card: the
    sun, the camera pose and the pinhole go in as tensors; the post effects
    (:func:`..render_fx.apply_post_fx`) and the writer stay outside. Without
    one the passes run eagerly on the rocks as given."""

    def __init__(self, conf: LabelingConf, render_settings=None,
                 rock_capacity: int | None = None):
        self.conf = conf
        # the RTX-style post pipeline on the RGB modality (startSim applies
        # lens flares / motion blur / chromatic aberrations before SDG runs)
        self.render_settings = render_settings
        self.rock_capacity = rock_capacity
        graphed = rock_capacity is not None
        self.top_down_fn = Graphed(top_down_pass) if graphed else top_down_pass
        self.camera_fn = Graphed(camera_pass) if graphed else camera_pass
        run_hash = hashlib.sha256(str(time.time()).encode()).hexdigest()[:10]
        self.run_dir = pathlib.Path(conf.data_dir) / run_hash
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.frame = 0
        self.seconds = {"top_down": 0.0, "camera": 0.0, "write": 0.0}

    def record(self, z: Tensor, resolution: float, origin=(0.0, 0.0),
               sun_direction=(0.4, 0.2, 0.9), rock_xy=None, rock_radius=None,
               pose=None) -> dict:
        """Render and write one top-down frame; returns the modalities as
        numpy arrays."""
        t0 = time.perf_counter()
        z = torch.as_tensor(z)
        sun, rocks = self._frame_inputs(z, sun_direction, rock_xy, rock_radius)
        drawn = self.top_down_fn(z, resolution, tuple(origin), sun, rocks, self.conf)
        out = {}
        if self.conf.save_rgb:
            rgb = drawn["rgb"]
            if self.render_settings is not None:
                rgb = apply_post_fx(rgb[..., None].repeat(1, 1, 3), self.render_settings)
            out["rgb"] = rgb
        if self.conf.save_depth:
            out["depth"] = z
        for name in ("normals", "semantic", "instance"):
            if name in drawn:
                out[name] = drawn[name]
        out = {k: _host(v) for k, v in out.items()}
        self.seconds["top_down"] += time.perf_counter() - t0
        self._write(out, pose)
        self.frame += 1
        return out

    def record_camera(self, z: Tensor, resolution: float, origin, rover_xy, heading_xy,
                      ground_z, intrinsics: CameraIntrinsics | None = None,
                      sun_direction=(0.4, 0.2, 0.9), rock_xy=None, rock_radius=None,
                      mount_height: float = 0.8, pitch_deg: float = 15.0, steps: int = 192,
                      max_range: float = 40.0, cast_shadows: bool = False,
                      frame: int | None = None) -> dict:
        """Render and write one robot-mounted perspective frame (depth / rgb
        / semantic / instance) with its intrinsics and pose JSON. ``frame``
        joins the camera products to an already-recorded capture (the
        top-down pass's id) without advancing the counter. Returns the
        rendered tensors."""
        t0 = time.perf_counter()
        intrinsics = intrinsics or CameraIntrinsics()
        saved_frame = self.frame
        if frame is not None:
            self.frame = int(frame)
        cam_pos, cam_R = camera_pose_from_rover(rover_xy, heading_xy, ground_z, mount_height,
                                                pitch_deg)
        z = torch.as_tensor(z)
        sun, rocks = self._frame_inputs(z, sun_direction, rock_xy, rock_radius)
        pose, pinhole = (cam_pos, cam_R), intrinsics
        if self.rock_capacity is not None:
            pose = tuple(_scalar(a, z) for a in pose)
            pinhole = intrinsics.pinhole(z)
        rendered = self.camera_fn(z, resolution, tuple(origin), *pose, pinhole, sun, rocks,
                                  steps, max_range, cast_shadows)
        if self.rock_capacity is not None:  # the graph's buffers: the next frame overwrites
            rendered = {k: v.clone() for k, v in rendered.items()}
        out = {f"cam_{k}": _host(v) for k, v in rendered.items() if k != "hit"}
        # finite PNG range: escaped rays render at max_range
        out["cam_depth"] = np.where(np.isfinite(out["cam_depth"]), out["cam_depth"], max_range)
        self.seconds["camera"] += time.perf_counter() - t0
        # joined captures: the top-down pass owns pose_{frame}.json; the
        # camera pose lives in camera_{frame}.json
        self._write(out, pose=None if frame is not None else cam_pos)
        with open(self.run_dir / f"camera_{self.frame:05d}.json", "w") as fh:
            json.dump({"intrinsics": intrinsics.as_dict(), "position": cam_pos.tolist(),
                       "rotation": cam_R.tolist()}, fh)
        if frame is None:
            self.frame += 1
        else:
            self.frame = saved_frame
        return rendered

    def _frame_inputs(self, z: Tensor, sun_direction, rock_xy, rock_radius):
        """The sun and the rocks of a frame as the passes take them: as
        given, or (with a rock capacity) the sun as a tensor and the rocks
        padded on the DEM's device."""
        if self.rock_capacity is None:
            return sun_direction, (np.zeros((0, 2)) if rock_xy is None else rock_xy,
                                   np.zeros((0,)) if rock_radius is None else rock_radius, None)
        return (_scalar(sun_direction, z),
                pad_rocks(rock_xy, rock_radius, self.rock_capacity, z.device))

    def _write(self, modalities: dict, pose) -> None:
        """``.npy`` of each modality, and a PNG of each 2-D one where PIL
        imports (rep_utils.py:17-476 writers)."""
        t0 = time.perf_counter()
        try:
            from PIL import Image
        except ImportError:
            Image = None
        for name, arr in modalities.items():
            np.save(self.run_dir / f"{name}_{self.frame:05d}.npy", arr)
            if Image is not None and arr.ndim == 2:
                img = arr.astype(np.float64)
                span = img.max() - img.min()
                img8 = ((img - img.min()) / (span + 1e-12) * 255).astype(np.uint8)
                Image.fromarray(img8).save(self.run_dir / f"{name}_{self.frame:05d}.png")
        if pose is not None:
            with open(self.run_dir / f"pose_{self.frame:05d}.json", "w") as fh:
                json.dump({"pose": np.asarray(pose).tolist()}, fh)
        self.seconds["write"] += time.perf_counter() - t0
