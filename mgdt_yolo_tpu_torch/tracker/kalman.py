"""Kalman filters of the trackers, the counterpart of the JAX package's
`mgdt_yolo_tpu/tracker/kalman.py`.

Two 8-state constant-velocity filters in float64 numpy:
`KalmanFilterXYAH` (ByteTrack: [cx, cy, aspect, h] and their velocities)
and `KalmanFilterXYWH` (BoT-SORT: [cx, cy, w, h] and theirs). Noise scales
1/20 of the size for position and 1/160 for velocity; the update solves
through a Cholesky factor (`scipy.linalg.cho_factor`/`cho_solve`);
`multi_predict` advances N tracks in one step.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg

# the 0.95 quantile of the chi-square distribution by degrees of freedom
# (the gate of `gating_distance`)
chi2inv95 = {1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877, 5: 11.070,
             6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919}


class KalmanFilterXYAH:
    """State [cx, cy, a, h, vcx, vcy, va, vh]; measurement [cx, cy, a, h]."""

    ndim = 4

    def __init__(self):
        self._F = np.eye(8)
        self._F[:4, 4:] = np.eye(4)  # dt = 1
        self._H = np.eye(4, 8)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    # the noise scales (XYWH overrides them)
    def _initiate_std(self, m):
        wp, wv = self._std_weight_position, self._std_weight_velocity
        return [2 * wp * m[3], 2 * wp * m[3], 1e-2, 2 * wp * m[3],
                10 * wv * m[3], 10 * wv * m[3], 1e-5, 10 * wv * m[3]]

    def _predict_std(self, mean):
        wp, wv = self._std_weight_position, self._std_weight_velocity
        return ([wp * mean[3], wp * mean[3], 1e-2, wp * mean[3]],
                [wv * mean[3], wv * mean[3], 1e-5, wv * mean[3]])

    def _project_std(self, mean):
        wp = self._std_weight_position
        return [wp * mean[3], wp * mean[3], 1e-1, wp * mean[3]]

    def _multi_std(self, means):
        """(N, 8) standard deviations of the process noise of `multi_predict`."""
        wp, wv = self._std_weight_position, self._std_weight_velocity
        h = means[:, 3]
        sp = np.stack([wp * h, wp * h, np.full_like(h, 1e-2), wp * h], 1)
        sv = np.stack([wv * h, wv * h, np.full_like(h, 1e-5), wv * h], 1)
        return np.concatenate([sp, sv], axis=1)

    def initiate(self, measurement: np.ndarray):
        """(mean (8,), covariance (8, 8)) of a track born at `measurement`."""
        mean = np.concatenate([measurement, np.zeros(4)])
        cov = np.diag(np.square(self._initiate_std(measurement)))
        return mean, cov

    def predict(self, mean, covariance):
        sp, sv = self._predict_std(mean)
        Q = np.diag(np.square(np.concatenate([sp, sv])))
        return self._F @ mean, self._F @ covariance @ self._F.T + Q

    def multi_predict(self, means: np.ndarray, covariances: np.ndarray):
        """`predict` of N tracks at once: (N, 8), (N, 8, 8)."""
        if len(means) == 0:
            return means, covariances
        Q = np.square(self._multi_std(means))
        means = means @ self._F.T
        covariances = self._F @ covariances @ self._F.T
        idx = np.arange(8)
        covariances[:, idx, idx] += Q
        return means, covariances

    def project(self, mean, covariance):
        """The state in measurement space: (mean (4,), covariance (4, 4))."""
        R = np.diag(np.square(self._project_std(mean)))
        return self._H @ mean, self._H @ covariance @ self._H.T + R

    def update(self, mean, covariance, measurement):
        pm, pc = self.project(mean, covariance)
        chol, lower = scipy.linalg.cho_factor(pc, lower=True, check_finite=False)
        K = scipy.linalg.cho_solve((chol, lower), (covariance @ self._H.T).T,
                                   check_finite=False).T
        mean = mean + K @ (measurement - pm)
        covariance = covariance - K @ pc @ K.T
        return mean, covariance

    def gating_distance(self, mean, covariance, measurements,
                        only_position: bool = False, metric: str = "maha"):
        """Squared distance of each of `measurements` (N, 4) from the
        state: Mahalanobis (`maha`) or Euclidean (`gaussian`)."""
        pm, pc = self.project(mean, covariance)
        if only_position:
            pm, pc = pm[:2], pc[:2, :2]
            measurements = measurements[:, :2]
        d = measurements - pm
        if metric == "gaussian":
            return np.sum(d * d, axis=1)
        chol = np.linalg.cholesky(pc)
        z = scipy.linalg.solve_triangular(chol, d.T, lower=True, check_finite=False,
                                          overwrite_b=True)
        return np.sum(z * z, axis=0)


class KalmanFilterXYWH(KalmanFilterXYAH):
    """State [cx, cy, w, h, ...]: the noise scales follow both w and h."""

    def _initiate_std(self, m):
        wp, wv = self._std_weight_position, self._std_weight_velocity
        return [2 * wp * m[2], 2 * wp * m[3], 2 * wp * m[2], 2 * wp * m[3],
                10 * wv * m[2], 10 * wv * m[3], 10 * wv * m[2], 10 * wv * m[3]]

    def _predict_std(self, mean):
        wp, wv = self._std_weight_position, self._std_weight_velocity
        return ([wp * mean[2], wp * mean[3], wp * mean[2], wp * mean[3]],
                [wv * mean[2], wv * mean[3], wv * mean[2], wv * mean[3]])

    def _project_std(self, mean):
        wp = self._std_weight_position
        return [wp * mean[2], wp * mean[3], wp * mean[2], wp * mean[3]]

    def _multi_std(self, means):
        wp, wv = self._std_weight_position, self._std_weight_velocity
        w, h = means[:, 2], means[:, 3]
        sp = np.stack([wp * w, wp * h, wp * w, wp * h], 1)
        sv = np.stack([wv * w, wv * h, wv * w, wv * h], 1)
        return np.concatenate([sp, sv], axis=1)
