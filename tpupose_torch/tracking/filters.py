"""Temporal filters: One-Euro and constant-acceleration Kalman.

Counterpart of `tpupose/tracking/filters.py`: ports of the reference's
`src/tracking/OneEuroFilter.py` (Casiez 1-euro filter; the reference makes
one per joint per track, `IterativeTracker.py:231-237`, though its use is
commented out in the shipped smoothing path) and
`src/tracking/KalmanFilter.py` (9-state position / velocity / acceleration
filter at 25 Hz, also disabled in the shipped path). Neither is on the
tracker's path. Both are functional over batched state tuples, so they
smooth whole (tracks, joints) batches at once, plus a scalar wrapper with
the reference's call shape.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class OneEuroState(NamedTuple):
    """State for a batch of 1-euro filters over arbitrarily shaped signals."""

    x_prev: torch.Tensor       # filtered value
    dx_prev: torch.Tensor      # filtered derivative
    t_prev: torch.Tensor       # previous timestamp
    initialized: torch.Tensor  # bool


def one_euro_init(shape, dtype=torch.float32, device=None) -> OneEuroState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return OneEuroState(z, z, z, torch.zeros(shape, dtype=torch.bool, device=device))


def _alpha(cutoff, dt):
    tau = 1.0 / (2.0 * math.pi) / cutoff
    return 1.0 / (1.0 + tau / dt)


def one_euro_apply(state: OneEuroState, x, t, freq=25.0, mincutoff=0.8,
                   beta=0.4, dcutoff=0.4):
    """One filtering step (vectorized over the state shape).

    The reference's configuration for 3D joints (`IterativeTracker.py:225-230`):
    freq 25, mincutoff 0.8, beta 0.4, dcutoff 0.4. Returns (state, x_hat).
    """
    x = torch.as_tensor(x, dtype=state.x_prev.dtype, device=state.x_prev.device)
    init = state.initialized
    dt = torch.where(init, t - state.t_prev, 1.0 / freq)
    dt = torch.where(dt > 0, dt, 1.0 / freq)
    dx = torch.where(init, (x - state.x_prev) / dt, 0.0)
    a_d = 1.0 / (1.0 + (1.0 / (2.0 * math.pi * dcutoff)) / dt)
    dx_hat = torch.where(init, a_d * dx + (1 - a_d) * state.dx_prev, dx)
    cutoff = mincutoff + beta * torch.abs(dx_hat)
    a = 1.0 / (1.0 + (1.0 / (2.0 * math.pi * cutoff)) / dt)
    x_hat = torch.where(init, a * x + (1 - a) * state.x_prev, x)
    new_state = OneEuroState(
        x_prev=x_hat, dx_prev=dx_hat,
        t_prev=torch.as_tensor(t, dtype=x_hat.dtype, device=x_hat.device) * torch.ones_like(x_hat),
        initialized=torch.ones_like(init),
    )
    return new_state, x_hat


class OneEuroFilter:
    """Scalar filter with the reference's call shape (`f(value, timestamp)`)."""

    def __init__(self, freq=25.0, mincutoff=1.0, beta=0.0, dcutoff=1.0):
        if freq <= 0 or mincutoff <= 0 or dcutoff <= 0:
            raise ValueError("freq, mincutoff, dcutoff must be > 0")
        self.freq = freq
        self.mincutoff = mincutoff
        self.beta = beta
        self.dcutoff = dcutoff
        self._x = None
        self._dx = 0.0
        self._t = None

    def __call__(self, x, timestamp=None):
        if x is None:
            return x
        if self._t is not None and timestamp is not None and timestamp > self._t:
            dt = timestamp - self._t
        else:
            dt = 1.0 / self.freq
        self._t = timestamp
        if self._x is None:
            self._x = x
            self._dx = 0.0
            return x
        dx = (x - self._x) / dt
        a_d = _alpha(self.dcutoff, dt)
        self._dx = a_d * dx + (1 - a_d) * self._dx
        cutoff = self.mincutoff + self.beta * abs(self._dx)
        a = _alpha(cutoff, dt)
        self._x = a * x + (1 - a) * self._x
        return self._x


class KalmanState(NamedTuple):
    """Constant-acceleration Kalman filter state for batched 3D points.

    State vector per point: [x y z vx vy vz ax ay az] (the reference's
    9-state cv2.KalmanFilter layout, `src/tracking/KalmanFilter.py:13-52`).
    """

    x: torch.Tensor  # (..., 9)
    P: torch.Tensor  # (..., 9, 9)


def kalman_matrices(hz=25.0, process_noise=0.007, measurement_noise=0.1,
                    device=None):
    """(F, H, Q, R), f32."""
    dt = 1.0 / hz
    v, a = dt, 0.5 * dt * dt
    F = torch.eye(9)
    for i in range(3):
        F[i, i + 3] = v
        F[i, i + 6] = a
        F[i + 3, i + 6] = v
    H = torch.zeros((3, 9))
    for i in range(3):
        H[i, i] = 1.0
        H[i, i + 3] = v
        H[i, i + 6] = a
    Q = torch.eye(9) * process_noise
    R = torch.eye(3) * measurement_noise
    return tuple(m.to(device) for m in (F, H, Q, R))


def kalman_init(pt3d) -> KalmanState:
    pt3d = torch.as_tensor(pt3d, dtype=torch.float32)
    x = torch.cat([pt3d, pt3d.new_zeros(pt3d.shape[:-1] + (6,))], dim=-1)
    P = torch.eye(9, device=pt3d.device).expand(pt3d.shape[:-1] + (9, 9))
    return KalmanState(x=x, P=P)


def kalman_predict(state: KalmanState, mats=None):
    """(predicted state, predicted measurement (..., 3))."""
    F, H, Q, R = mats if mats is not None else kalman_matrices(device=state.x.device)
    x = torch.einsum("ij,...j->...i", F, state.x)
    P = torch.einsum("ij,...jk,lk->...il", F, state.P, F) + Q
    return KalmanState(x=x, P=P), torch.einsum("ij,...j->...i", H, x)


def kalman_correct(state: KalmanState, measurement, mats=None):
    F, H, Q, R = mats if mats is not None else kalman_matrices(device=state.x.device)
    z = torch.as_tensor(measurement, dtype=torch.float32, device=state.x.device)
    y = z - torch.einsum("ij,...j->...i", H, state.x)
    S = torch.einsum("ij,...jk,lk->...il", H, state.P, H) + R
    K = torch.einsum("...ij,jk,...kl->...il", state.P, H.T, torch.linalg.inv(S))
    x = state.x + torch.einsum("...ij,...j->...i", K, y)
    P = state.P - torch.einsum("...ij,jk,...kl->...il", K, H, state.P)
    return KalmanState(x=x, P=P)
