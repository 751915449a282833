"""NumPy oracle of the production (Warp-kernel) MPPI semantics.

A copy of ``husky_rover_mppi_isaacsim_tpu/compat/warp_oracle.py`` (this
package imports nothing of that one, so it runs where jax is not installed): a
deliberately slow, scalar, loop-for-loop NumPy re-derivation of the math in
``thesis_master/warp_implementation/{projection,sampling,critics}_warp.py``,
the golden reference the rollouts, critics and weights must match (exactly
in float64, to tight tolerance in float32). Used by tests and by
``chip_smoke.py``'s ``k1_vs_oracle`` phase; never imported by the
production path.

Every function cites the reference location it re-derives. No reference code
was copied; this is a from-scratch transcription of the documented math.
"""

from __future__ import annotations

import numpy as np


# --- heightfield ops (projection_warp.py:8-151) -----------------------------

def corner_cell(x, y, x_min, y_min, resolution):
    """projection_warp.py:39-40 (note the sign quirk on j)."""
    i = int(np.trunc((x - x_min) / resolution))
    j = -int(np.trunc((y + y_min) / resolution))
    return i, j


def gather_corners(z, i, j):
    """projection_warp.py:43-46; ``z`` is the (grid, grid) height array."""
    q = np.empty((2, 2), dtype=z.dtype)
    q[0, 0] = z[j, i]
    q[0, 1] = z[j, i + 1]
    q[1, 0] = z[j + 1, i]
    q[1, 1] = z[j + 1, i + 1]
    return q


def bilinear(x, y, q, resolution):
    """projection_warp.py:89-98 (trunc fractions, transposed weight pairing)."""
    xn = x / resolution
    yn = y / resolution
    x2 = xn - np.trunc(xn)
    y2 = yn - np.trunc(yn)
    return (
        (1.0 - x2) * (1.0 - y2) * q[0, 0]
        + x2 * (1.0 - y2) * q[1, 0]
        + (1.0 - x2) * y2 * q[0, 1]
        + x2 * y2 * q[1, 1]
    )


def quad_normal(q, resolution):
    """projection_warp.py:141-151."""
    vx = -resolution / 2.0 * (q[0, 1] - q[0, 0] - q[1, 0] + q[1, 1])
    vy = -resolution / 2.0 * (q[1, 0] - q[0, 0] - q[0, 1] + q[1, 1])
    vz = resolution * resolution
    vec = np.array([vx, vy, vz])
    return vec / np.sqrt(vx * vx + vy * vy + vz * vz)


def tangent_project(normal, heading):
    """projection_warp.py:181-190."""
    proj = heading - np.dot(heading, normal) * normal
    return proj / np.sqrt(np.dot(proj, proj))


def update_position(x, y, heading, lin, dt):
    """projection_warp.py:207-223."""
    heading = heading / np.sqrt(np.dot(heading, heading))
    disp = heading * lin * dt
    return x + disp[0], y + disp[1]


def update_orientation(heading, ang, normal, dt):
    """projection_warp.py:225-248 (Rodrigues about the surface normal)."""
    heading = heading / np.sqrt(np.dot(heading, heading))
    angle = ang * dt
    c, s = np.cos(angle), np.sin(angle)
    rotated = (
        heading * c
        + np.cross(normal, heading) * s
        + normal * np.dot(normal, heading) * (1.0 - c)
    )
    return rotated / np.sqrt(np.dot(rotated, rotated))


def update_orientation_2d(heading, ang, dt):
    """projection_warp.py:251-275."""
    theta = ang * dt
    c, s = np.cos(theta), np.sin(theta)
    nx = c * heading[0] - s * heading[1]
    ny = s * heading[0] + c * heading[1]
    norm = np.sqrt(nx * nx + ny * ny)
    if norm > 0.0:
        nx /= norm
        ny /= norm
    return np.array([nx, ny, 0.0])


# --- rollouts (projection_warp.py:284-383) ----------------------------------

def rollout_25d(z, x_min, y_min, resolution, position, heading, lin, ang, dt,
                wheel_offset=0.2):
    """Single-trajectory mirror of ``_generate_trajectories_kernel``
    (projection_warp.py:284-350). ``lin``/``ang`` are (H,) arrays."""
    horizon = len(lin)
    traj = np.zeros((horizon, 3))
    headings = np.zeros((horizon, 3))
    lw = np.zeros((horizon, 3))
    rw = np.zeros((horizon, 3))

    x, y = float(position[0]), float(position[1])
    q = gather_corners(z, *corner_cell(x, y, x_min, y_min, resolution))
    normal = quad_normal(q, resolution)
    prev = tangent_project(normal, np.asarray(heading, dtype=z.dtype))

    grid = z.shape[-1]
    for k in range(horizon):
        x, y = update_position(x, y, prev, lin[k], dt)
        i, j = corner_cell(x, y, x_min, y_min, resolution)
        # upper-bound min() mirrors XLA; negative indices deliberately NOT
        # clamped — a traced jnp gather wraps them NumPy-style (verified:
        # jit z[-1] reads the last row), so Python indexing already matches
        i, j = min(i, grid - 2), min(j, grid - 2)
        q = gather_corners(z, i, j)
        height = bilinear(x, y, q, resolution)
        normal = quad_normal(q, resolution)
        prev = tangent_project(normal, prev)
        current = update_orientation(prev, ang[k], normal, dt)
        headings[k] = current
        traj[k] = [x, y, height]

        right = wheel_offset * np.cross(normal, current)
        for sign, out in ((1.0, lw), (-1.0, rw)):
            xw = x + sign * right[0]
            yw = y + sign * right[1]
            iw, jw = corner_cell(xw, yw, x_min, y_min, resolution)
            out[k] = [xw, yw, z[min(jw, grid - 1), min(iw, grid - 1)]]
        prev = current

    return traj, headings, lw, rw


def rollout_2d(z, x_min, y_min, resolution, position, heading, lin, ang, dt):
    """Mirror of ``_generate_trajectories_2D_kernel``
    (projection_warp.py:353-383)."""
    horizon = len(lin)
    traj = np.zeros((horizon, 3))
    headings = np.zeros((horizon, 3))
    x, y = float(position[0]), float(position[1])
    prev = np.asarray(heading, dtype=z.dtype)
    grid = z.shape[-1]
    for k in range(horizon):
        x, y = update_position(x, y, prev, lin[k], dt)
        headings[k] = update_orientation_2d(prev, ang[k], dt)
        i, j = corner_cell(x, y, x_min, y_min, resolution)
        i, j = min(i, grid - 2), min(j, grid - 2)
        q = gather_corners(z, i, j)
        traj[k] = [x, y, bilinear(x, y, q, resolution)]
        prev = headings[k]
    return traj, headings


# --- sampling + dynamics (sampling_warp.py) ---------------------------------

def perturb(optimal_u1, optimal_u2, noise, std_u1, std_u2,
            min_u1, max_u1, min_u2, max_u2):
    """Mirror of ``_generate_inputs_kernel`` (sampling_warp.py:54-92) with
    injected noise: step h perturbs optimal[h+1] (last step: optimal[H-1])."""
    horizon = len(optimal_u1)
    base1 = np.concatenate([optimal_u1[1:], optimal_u1[-1:]])
    base2 = np.concatenate([optimal_u2[1:], optimal_u2[-1:]])
    u1 = np.clip(base1[None, :] + std_u1 * noise[0], min_u1, max_u1)
    u2 = np.clip(base2[None, :] + std_u2 * noise[1], min_u2, max_u2)
    return u1, u2


def wheel_lag(u1, u2, left0, right0, track, v_min, v_max, w_min, w_max, k, a):
    """Mirror of ``_convert_inputs_to_velocities`` (sampling_warp.py:96-139).
    ``u1``/``u2`` are (K, H)."""
    num, horizon = u1.shape
    lin = np.zeros_like(u1)
    ang = np.zeros_like(u1)
    for t in range(num):
        left, right = left0, right0
        for h in range(horizon):
            left = left * a + u1[t, h] * k * (1.0 - a)
            right = right * a + u2[t, h] * k * (1.0 - a)
            lin[t, h] = np.clip((left + right) / 2.0, v_min, v_max)
            ang[t, h] = np.clip((-left + right) / track, w_min, w_max)
    return lin, ang


# --- critics (critics_warp.py) ----------------------------------------------

def path_follow_critic(x, y, goal, traj, horizon_m):
    """critics_warp.py:86-127."""
    eps = 1e-6
    xd, yd = goal[0] - x, goal[1] - y
    dist = np.sqrt(xd * xd + yd * yd)
    last = traj[-1]
    if dist > horizon_m:
        igx = x + xd * horizon_m / (dist + eps)
        igy = y + yd * horizon_m / (dist + eps)
        cost = (last[0] - igx) ** 2 + (last[1] - igy) ** 2
        return cost * (1.0 + 2.0 * horizon_m / dist)
    cost = 0.0
    for i in range(len(traj) - 1):
        cost += 10.0 * (abs(traj[i][0] - goal[0]) + abs(traj[i][1] - goal[1]))
    return cost


def _pair_slope_sum(points_a, points_b=None):
    """critics_warp.py:151-218 loop: i = 0, 2, ... < H-3."""
    eps = 1e-6
    horizon = len(points_a)
    total = 0.0
    for i in range(0, horizon - 3, 2):
        def slope(points):
            dz = points[i + 2][2] - points[i][2]
            d = np.sqrt((points[i + 2][0] - points[i][0]) ** 2
                        + (points[i + 2][1] - points[i][1]) ** 2)
            r = abs(dz / (d + eps))
            return (1.0 + 5.0 * r) ** 2
        if points_b is None:
            total += slope(points_a)
        else:
            total += max(slope(points_a), slope(points_b))
    return total


def avoid_slope_critic(traj):
    return _pair_slope_sum(traj)


def avoid_slope_wheels_critic(lw, rw):
    return _pair_slope_sum(lw, rw)


def avoid_obstacle_critic(traj, costmap, half_width, resolution_cm):
    """critics_warp.py:220-267 (row-major: idx = ix + size*iy)."""
    size = costmap.shape[-1]
    cost = 0.0
    for p in traj:
        ix = int(np.trunc((p[0] + half_width) / resolution_cm))
        iy = int(np.trunc((-p[1] + half_width) / resolution_cm))
        c = costmap[min(iy, size - 1), min(ix, size - 1)]
        if c > 0.99:
            cost += 100000.0
        cost += c
    return cost


def maximise_speed_critic(x, y, goal, lin, target_speed):
    """critics_warp.py:269-300."""
    xd, yd = goal[0] - x, goal[1] - y
    if np.sqrt(xd * xd + yd * yd) < 2.0:
        return 0.0
    return float(np.sum((target_speed - lin) / (lin + 1e-4)))


def evaluate_trajectories(x, y, goal, trajs, lws, rws, lins, target_speed,
                          costmap, half_width, resolution_cm, horizon_m,
                          w_pf=100.5, w_slope=50.5, w_speed=0.5, w_obs=25.0):
    """critics_warp.py:302-329 over a (K, H, 3) batch."""
    num = len(trajs)
    costs = np.zeros(num)
    for t in range(num):
        costs[t] = (
            w_pf * path_follow_critic(x, y, goal, trajs[t], horizon_m)
            + w_slope * avoid_slope_wheels_critic(lws[t], rws[t])
            + w_speed * maximise_speed_critic(x, y, goal, lins[t], target_speed)
            + w_obs * avoid_obstacle_critic(trajs[t], costmap, half_width,
                                            resolution_cm)
        )
    return costs


def softmax_weights(costs, temperature):
    """Two-pass min + exp: the deterministic semantics of the controller's
    weights (see critics_warp.py:338-347 race note in SURVEY.md §5)."""
    return np.exp(-(costs - np.min(costs)) / temperature)


def weighted_update(weights, u1, u2):
    """critics_warp.py:363-376."""
    total = np.sum(weights)
    return (weights @ u1) / total, (weights @ u2) / total
