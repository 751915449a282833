"""Samplers: randomized draws over a layer's randomization space.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/worldbuilders/samplers.py``
(the re-derivation of ``WorldBuilders/Samplers.py``, reference :5-839):
every sampler takes its config dataclass, owns a
``np.random.default_rng(seed)``, supports plain sampling, equation-based
rejection (re-drawing until the layer's boundary check passes), and
image-mask-weighted sampling. The cluster point processes (Matern/Thomas,
hardcore variants) return a data-dependent number of points.

Which side draws: every random draw is the numpy generator's, made in the
JAX package's order and with its arguments, so counts and coordinates equal
the JAX package's (as the port's crater and rock placement do). Everything
computed from the draws (boundary checks, warps, cluster offsets, the
hard-core thinning) is float64 torch on the sampler's device; a sampler
returns an ``(n, d)`` float64 tensor there.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..core.device import run_device
from . import types as T
from ._tensor import F64, f64, scalar

# the hard-core thinning's pair distances are computed in row chunks of at
# most this many pairs (float64: ~270 MB per intermediate)
PAIR_CHUNK = 1 << 25


class BaseSampler:
    def __init__(self, cfg: T.Sampler_T, device=None):
        self._cfg = cfg
        self.device = run_device(device)
        self._rng = (
            np.random.default_rng(cfg.seed) if cfg.seed != -1
            else np.random.default_rng()
        )
        self._check_fn = lambda pts: torch.ones(pts.shape[0], dtype=torch.bool,
                                                device=pts.device)
        self.mask = None
        self.parents_coords = []

    # layer hooks ------------------------------------------------------------
    def set_check_fn(self, fn):
        self._check_fn = fn

    def set_mask(self, mask: np.ndarray, mpp: float):
        """Image-weighted sampling support (Samplers.py:23-30); the pixel
        probabilities stay on the host, they feed the generator's draw."""
        self.mask = np.asarray(mask, float)
        self.H, self.W = self.mask.shape
        self.mpp = mpp
        flat = self.mask.flatten()
        self.idx = np.arange(flat.shape[0])
        self.p = flat / flat.sum()

    # dispatch ---------------------------------------------------------------
    def __call__(self, num=1, **kwargs):
        if self._cfg.use_rejection_sampling:
            return self.sample_rejection(num=num, **kwargs)
        if self._cfg.use_image_sampling:
            return self.sample_image(num=num, **kwargs)
        return self.sample(num=num, **kwargs)

    def sample(self, num=1, **kwargs):
        raise NotImplementedError

    def sample_rejection(self, num=1, **kwargs):
        """Re-draw until ``num`` in-boundary points or the loop cap
        (Samplers.py:54-67)."""
        points, total = [], 0
        for _ in range(self._cfg.max_rejection_sampling_loop):
            if total >= num:
                break
            pts = self.sample(num=num, **kwargs)
            ok = self._check_fn(pts)
            n_ok = int(ok.sum())
            if n_ok:
                points.append(pts[ok])
                total += n_ok
        if not points:
            return torch.zeros((0, self._cfg.randomization_space), dtype=F64,
                               device=self.device)
        return torch.cat(points)[:num]

    def _image_points(self, num):
        """Mask-weighted pixel draw + in-pixel jitter (Samplers.py:69-80).

        NOTE: the row flip ``H - row`` is the reference's own formula and
        disagrees by one row with the clippers' lower-origin inverse
        ``(H-1) - y/mpp`` (Clippers.py:35); both sides copy the reference
        as it is, so mask-sampled points paired with an image clipper read
        the adjacent DEM row exactly as upstream does."""
        idx = self._rng.choice(self.idx, p=self.p, size=num)
        local = self._rng.uniform(0, self.mpp, size=(num, self._cfg.randomization_space))
        idx = torch.as_tensor(idx, device=self.device)
        y = self.H - idx // self.mask.shape[1]
        x = idx % self.mask.shape[1]
        return torch.stack([x, y], dim=1).to(F64) * self.mpp + f64(local, self.device)

    def sample_image(self, num=1, **kwargs):
        return self._image_points(num)

    def _uniform_box(self, num):
        """One uniform draw per axis, in axis order, as ``(num, d)``."""
        cfg = self._cfg
        return f64(np.stack([self._rng.uniform(cfg.min[d], cfg.max[d], num)
                             for d in range(cfg.randomization_space)]).T, self.device)


class UniformSampler(BaseSampler):
    """Samplers.py:45-80."""

    def sample(self, num=1, **kwargs):
        pts = self._uniform_box(num)
        return pts[self._check_fn(pts)]


def _hardcore_reject(rng: np.random.Generator, coords: Tensor, core_radius: float) -> Tensor:
    """Age-mark hard-core thinning (Samplers.py:120-133): one uniform mark
    per point (the generator's draw), then a point is kept when its mark is
    below every mark within ``core_radius`` of it. The JAX package builds
    the dense n x n distance matrix; here it is computed in row chunks on
    the points' device with the same float64 arithmetic (``sqrt`` of the
    squared differences summed in axis order, ``0 < d < core_radius``), so
    the kept set is the JAX package's."""
    n = coords.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=coords.device)
    marks = f64(rng.uniform(0, 1, n), coords.device)
    inf = scalar(float("inf"), coords.device)
    keep = torch.empty(n, dtype=torch.bool, device=coords.device)
    rows = max(1, PAIR_CHUNK // n)
    for r0 in range(0, n, rows):
        block = coords[r0:r0 + rows]
        sq = None
        for d in range(coords.shape[1]):
            diff = block[:, None, d] - coords[None, :, d]
            sq = diff * diff if sq is None else sq + diff * diff
        dist = torch.sqrt(sq)
        in_disk = (dist < core_radius) & (dist > 0)
        neighbor_min = torch.where(in_disk, marks[None, :], inf).amin(dim=1)
        keep[r0:r0 + rows] = marks[r0:r0 + rows] < neighbor_min
    return keep


class HardCoreUniformSampler(BaseSampler):
    """Samplers.py:82-150."""

    def _draw(self, num):
        pts = self._uniform_box(num)
        return pts[self._check_fn(pts)]

    def sample(self, num=1, **kwargs):
        pts = self._draw(num)
        for _ in range(self._cfg.num_repeat):
            pts = pts[_hardcore_reject(self._rng, pts, self._cfg.core_radius)]
            pts = torch.cat([pts, self._draw(num)])
        pts = pts[_hardcore_reject(self._rng, pts, self._cfg.core_radius)]
        return pts[:num]


class NormalSampler(BaseSampler):
    """Samplers.py:152-239."""

    def sample(self, num=1, **kwargs):
        pts = f64(self._rng.multivariate_normal(self._cfg.mean, self._cfg.std, num), self.device)
        return pts[self._check_fn(pts)]


class MaternClusterPointSampler(BaseSampler):
    """Matern cluster process: Poisson parents on the cluster-radius-extended
    bounds, Poisson-many daughters uniform in a disk/ball around each parent
    (Samplers.py:241-379). Supports the polar ``warp`` option and parent
    inheritance for coupled requests."""

    def _extension(self) -> float:
        return self._cfg.cluster_radius

    def get_parents(self, bounds, area=None):
        """Parents uniform on the bounds extended by :meth:`_extension`
        (the bounds are host config; the count and coordinates are
        draws)."""
        cfg = self._cfg
        b = np.array(bounds, dtype=float)
        if cfg.warp is not None:
            b = (b.T * np.array(cfg.warp)).T
        b[:, 0] -= self._extension()
        b[:, 1] += self._extension()
        area_ext = np.prod(b[:, 1] - b[:, 0]) if area is None else area
        n = self._rng.poisson(area_ext * cfg.lambda_parent)
        coords = [float(b[i, 0]) + float(b[i, 1] - b[i, 0])
                  * f64(self._rng.uniform(0, 1, n), self.device)
                  for i in range(b.shape[0])]
        return torch.stack(coords, dim=1)

    def _offsets(self, total: int) -> Tensor:
        """Daughter offsets: uniform in a disk (2D) or a ball (3D)."""
        cfg = self._cfg
        theta = 2 * np.pi * f64(self._rng.uniform(0, 1, total), self.device)
        rho = cfg.cluster_radius * torch.sqrt(f64(self._rng.uniform(0, 1, total), self.device))
        if cfg.randomization_space == 3:
            phi = 2 * np.pi * f64(self._rng.uniform(0, 1, total), self.device)
            return torch.stack([torch.sin(phi) * torch.cos(theta) * rho,
                                torch.sin(phi) * torch.sin(theta) * rho,
                                torch.cos(phi) * rho], dim=1)
        return torch.stack([rho * torch.cos(theta), rho * torch.sin(theta)], dim=1)

    def get_daughters(self, parents: Tensor):
        cfg = self._cfg
        counts = self._rng.poisson(cfg.lambda_daughter, parents.shape[0])
        local = self._offsets(int(counts.sum()))
        pts = local + torch.repeat_interleave(
            parents, torch.as_tensor(counts, device=self.device), dim=0)
        if cfg.warp is not None:
            pts = pts / f64(cfg.warp, self.device)
        return pts[self._check_fn(pts)]

    def sample(self, num=1, bounds=(), area=None, parents=(), **kwargs):
        if getattr(self._cfg, "inherit_parents", False) and len(parents):
            self.parents_coords = f64(parents, self.device)
        else:
            self.parents_coords = self.get_parents(bounds, area=area)
        return self.get_daughters(self.parents_coords)

    def sample_rejection(self, num=1, **kwargs):
        return self.sample(num=num, **kwargs)


class HardCoreMaternClusterPointSampler(MaternClusterPointSampler):
    """Samplers.py:381-482."""

    def sample(self, num=1, bounds=(), area=None, parents=(), **kwargs):
        self.parents_coords = self.get_parents(bounds, area=area)
        pts = self.get_daughters(self.parents_coords)
        for _ in range(self._cfg.num_repeat):
            pts = pts[_hardcore_reject(self._rng, pts, self._cfg.core_radius)]
            pts = torch.cat([pts, self.get_daughters(self.parents_coords)])
        return pts[_hardcore_reject(self._rng, pts, self._cfg.core_radius)]


class ThomasClusterSampler(MaternClusterPointSampler):
    """Thomas process: Gaussian daughters, 6-sigma bound extension
    (Samplers.py:484-618)."""

    def _extension(self) -> float:
        return self._cfg.sigma * 6

    def _offsets(self, total: int) -> Tensor:
        cfg = self._cfg
        return f64(np.stack([self._rng.normal(0, cfg.sigma, total)
                             for _ in range(cfg.randomization_space)]).T, self.device)


class HardCoreThomasClusterSampler(ThomasClusterSampler):
    """Samplers.py:620-712."""

    sample = HardCoreMaternClusterPointSampler.sample


class PoissonPointSampler(BaseSampler):
    """Homogeneous Poisson process over the layer bounds
    (Samplers.py:714-755)."""

    def sample(self, num=1, bounds=(), area=None, **kwargs):
        b = np.array(bounds, dtype=float)
        area_b = np.prod(b[:, 1] - b[:, 0]) if area is None else area
        n = self._rng.poisson(area_b * self._cfg.lambda_poisson)
        pts = f64(np.stack([self._rng.uniform(b[i, 0], b[i, 1], n)
                            for i in range(b.shape[0])]).T, self.device)
        return pts[self._check_fn(pts)]


def _linspace(start: float, stop: float, num: int, device) -> Tensor:
    """``np.linspace(start, stop, num)`` in float64 on ``device``, numpy's
    arithmetic (``arange * step + start``, the last point set to ``stop``)."""
    div = num - 1
    y = torch.arange(num, dtype=F64, device=device)
    delta = float(stop) - float(start)
    if div > 0:
        step = delta / div
        y = y / scalar(div, device) * delta if step == 0 else y * step
        y = y + float(start)
        y[-1] = float(stop)
    else:
        y = y * delta + float(start)
    return y


class LinearInterpolationSampler(BaseSampler):
    """Evenly-spaced points min..max (Samplers.py:757-802)."""

    def sample(self, num=1, **kwargs):
        cfg = self._cfg
        return torch.stack([_linspace(cfg.min[d], cfg.max[d], num, self.device)
                            for d in range(cfg.randomization_space)], dim=1)


class DeterministicSampler(BaseSampler):
    """Replays fixed data points (Samplers.py:804-815)."""

    def sample(self, num=1, **kwargs):
        return f64(self._cfg.data, self.device)[:num]


class SamplerFactory:
    def __init__(self):
        self._creators = {}

    def register(self, name, cls):
        self._creators[name] = cls

    def get(self, cfg, device=None, **kwargs):
        """The sampler for ``cfg`` on ``device`` (default: the card, see
        :func:`..core.device.run_device`)."""
        name = cfg.__class__.__name__
        if name not in self._creators:
            raise ValueError(f"Unknown sampler requested: {name}")
        return self._creators[name](cfg, device=device)


Sampler_Factory = SamplerFactory()
Sampler_Factory.register("UniformSampler_T", UniformSampler)
Sampler_Factory.register("HardCoreUniformSampler_T", HardCoreUniformSampler)
Sampler_Factory.register("NormalSampler_T", NormalSampler)
Sampler_Factory.register("MaternClusterPointSampler_T", MaternClusterPointSampler)
Sampler_Factory.register(
    "HardCoreMaternClusterPointSampler_T", HardCoreMaternClusterPointSampler
)
Sampler_Factory.register("ThomasClusterSampler_T", ThomasClusterSampler)
Sampler_Factory.register("HardCoreThomasClusterSampler_T", HardCoreThomasClusterSampler)
Sampler_Factory.register("PoissonPointSampler_T", PoissonPointSampler)
Sampler_Factory.register("LinearInterpolationSampler_T", LinearInterpolationSampler)
Sampler_Factory.register("DeterministicSampler_T", DeterministicSampler)
