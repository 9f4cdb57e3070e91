"""Batched constant-velocity Kalman filter over the track table (the
port of the reference package's ``tracking/kalman.py``).

Per track, each measurement coordinate z in {cx, cy, w, h} has an
independent (position, velocity) state with a 2x2 covariance, packed as
(B, T, 4, 3) = [p_xx, p_xv, p_vv].  Everything is vectorized over the
full (B, T) table and keeps the reference's operation order.
"""
from __future__ import annotations

import torch

from ..device import resolve_device


def kf_predict(pos, vel, cov, q: float, dt: float = 1.0):
    """Advance every track one time step under constant velocity.

    ``q`` is the white-noise-acceleration intensity; the discrete
    process noise is Q = q * [[dt^4/4, dt^3/2], [dt^3/2, dt^2]].
    """
    pxx, pxv, pvv = cov[..., 0], cov[..., 1], cov[..., 2]
    pos = pos + vel * dt
    pxx = pxx + dt * (2.0 * pxv + dt * pvv) + q * dt ** 4 / 4.0
    pxv = pxv + dt * pvv + q * dt ** 3 / 2.0
    pvv = pvv + q * dt * dt
    return pos, vel, torch.stack([pxx, pxv, pvv], -1)


def kf_update(pos, vel, cov, z, r: float, gate):
    """Measurement update with z (B, T, 4); ``gate`` (B, T, 1) selects
    the tracks that matched a detection this frame (the rest keep their
    predicted state).  With H = [1, 0] and scalar measurement noise r
    per coordinate the gain is K = [p_xx, p_xv] / (p_xx + r)."""
    pxx, pxv, pvv = cov[..., 0], cov[..., 1], cov[..., 2]
    s = pxx + r
    k1 = pxx / s
    k2 = pxv / s
    y = z - pos
    pos_u = pos + k1 * y
    vel_u = vel + k2 * y
    cov_u = torch.stack([(1.0 - k1) * pxx, (1.0 - k1) * pxv,
                         pvv - k2 * pxv], -1)
    pos = torch.where(gate, pos_u, pos)
    vel = torch.where(gate, vel_u, vel)
    cov = torch.where(gate[..., None], cov_u, cov)
    return pos, vel, cov


def init_cov(shape, r: float, p0_vel: float, device=None):
    """Fresh-track covariance on ``device`` (None: ``cuda``): position
    pinned to the measurement noise, velocity wide open so the second
    match locks the velocity."""
    device = resolve_device(device)
    cov = torch.zeros(tuple(shape) + (3,), dtype=torch.float32,
                      device=device)
    cov[..., 0] = r
    cov[..., 2] = p0_vel
    return cov
