"""Bekker/Wong wheel terramechanics: drawbar pull, normal load and
resistance torque per wheel from slip ratio and sinkage (counterpart of the
JAX ``physics/terramechanics.py``).

Re-derivation of ``src/physics/terramechanics_solver.py:33-226``: the
contact-angle stress integrals are fixed-order Gauss-Legendre sums,
vectorized over every wheel of every rover, in float32 on the device of the
inputs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import Tensor


@dataclasses.dataclass
class RobotParameter:
    """terramechanics_solver.py RobotParameter."""

    wheel_radius: float = 0.165
    wheel_base: float = 0.25  # wheel width b


@dataclasses.dataclass
class TerrainMechanicalParameter:
    """Lunar-regolith-ish Bekker/Wong parameters."""

    c: float = 170.0         # cohesion [Pa]
    phi: float = 0.6109      # internal friction angle [rad] (35 deg)
    K: float = 0.018         # shear deformation modulus [m]
    k_c: float = 1400.0      # cohesive modulus
    k_phi: float = 820000.0  # frictional modulus
    n: float = 1.0           # sinkage exponent
    rho: float = 1660.0      # soil density [kg/m^3]
    a_0: float = 0.4         # max-stress-angle coefficients
    a_1: float = 0.15


_GL_ORDER = 32
_GL_X, _GL_W = np.polynomial.legendre.leggauss(_GL_ORDER)


def _integrate(fn, lo: Tensor, hi: Tensor) -> Tensor:
    """Fixed-order Gauss-Legendre quadrature of ``fn`` over ``[lo, hi]``;
    ``lo``/``hi`` broadcast over the wheel batch."""
    x = torch.as_tensor(_GL_X, dtype=torch.float32, device=lo.device)
    w = torch.as_tensor(_GL_W, dtype=torch.float32, device=lo.device)
    half = (hi - lo) / 2.0
    mid = (hi + lo) / 2.0
    theta = mid[..., None] + half[..., None] * x
    return half * torch.sum(fn(theta) * w, dim=-1)


class TerramechanicsSolver:
    """Batched wheel force/torque solver (compute_force_and_torque,
    terramechanics_solver.py:203-226)."""

    def __init__(self, robot: RobotParameter | None = None,
                 terrain: TerrainMechanicalParameter | None = None):
        self.robot = robot or RobotParameter()
        self.terrain = terrain or TerrainMechanicalParameter()

    def slip_ratio(self, v: Tensor, omega: Tensor) -> Tensor:
        """Driving vs braking slip (terramechanics_solver.py:33-42)."""
        wr = omega * self.robot.wheel_radius
        eps = 1e-9
        driving = 1.0 - v / (wr + eps)
        braking = wr / (v + eps) - 1.0
        return torch.where(v <= wr, driving, braking)

    def _sigma(self, theta, theta_f, theta_m, theta_r, sigma_max, upper: bool):
        """Normal stress profile: the rear (``upper``) or front branch
        (terramechanics_solver.py:54-84)."""
        if not upper:
            return sigma_max * (torch.cos(theta) - torch.cos(theta_f))
        ratio = (theta - theta_r) / torch.clamp(theta_m - theta_r, min=1e-9)
        return sigma_max * (torch.cos(theta_f - ratio * (theta_f - theta_m))
                            - torch.cos(theta_f))

    def _tau(self, theta, theta_f, theta_m, theta_r, sigma_max, slip, upper: bool):
        """Shear stress via Janosi-Hanamoto (terramechanics_solver.py:86-160)."""
        r = self.robot.wheel_radius
        j_theta = r * (theta_f - theta - (1.0 - slip) * (torch.sin(theta_f) - torch.sin(theta)))
        sigma = self._sigma(theta, theta_f, theta_m, theta_r, sigma_max, upper)
        t = self.terrain
        return (t.c + sigma * math.tan(t.phi)) * (1.0 - torch.exp(-j_theta / t.K))

    def compute_force_and_torque(self, velocity, omega, sinkage) -> tuple[Tensor, Tensor]:
        """Forces ``(..., 3)`` and torques ``(..., 3)`` per wheel from
        ``velocity``, ``omega`` and ``sinkage`` of any broadcastable batch
        shape."""
        r, b, t = self.robot.wheel_radius, self.robot.wheel_base, self.terrain
        velocity = torch.as_tensor(velocity, dtype=torch.float32)
        omega = torch.as_tensor(omega, dtype=torch.float32,
                                device=velocity.device).expand(velocity.shape)
        sinkage = torch.as_tensor(sinkage, dtype=torch.float32,
                                  device=velocity.device).expand(velocity.shape)

        slip = self.slip_ratio(velocity, omega)
        # arctan(1 - z/r) as the reference solver has it
        # (terramechanics_solver.py:50); classical contact geometry is
        # arccos(1 - z/r), see the JAX package's note
        theta_f = torch.atan(1.0 - sinkage / r)
        theta_r = torch.zeros_like(theta_f)
        theta_m = (t.a_0 + t.a_1 * slip) * theta_f
        sigma_max = ((t.c * t.k_c) + (t.rho * 9.81 * b * t.k_phi)) * (r / b) ** t.n
        geo = (theta_f[..., None], theta_m[..., None], theta_r[..., None], sigma_max)
        s = slip[..., None]

        def both(weight, stress):
            """The rear integral over [theta_r, theta_m] plus the front one
            over [theta_m, theta_f] of ``stress * weight``."""
            return (_integrate(lambda th: stress(th, True) * weight(th), theta_r, theta_m)
                    + _integrate(lambda th: stress(th, False) * weight(th), theta_m, theta_f))

        def tau(th, upper):
            return self._tau(th, *geo, s, upper)

        def sigma(th, upper):
            return self._sigma(th, *geo, upper)

        fx = r * b * (both(torch.cos, tau) - both(torch.sin, sigma))
        fz = r * b * (both(torch.sin, tau) - both(torch.cos, sigma))
        my = (r ** 2) * b * both(lambda th: 1.0, tau)
        zeros = torch.zeros_like(fx)
        return torch.stack([fx, zeros, fz], dim=-1), torch.stack([zeros, my, zeros], dim=-1)
