"""The "bench" training views: tools/bench.py's 24 TRAIN_VIEWS, frozen at
commit b2b746adc8850e97c8bf961cd6f4acbaa347c7b1: camera(yaw, tx, ty, tz)
turns by yaw about y and translates by t."""
from __future__ import annotations

import math

import numpy as np


def views(spec: dict, rng: np.random.Generator) -> list:
    """The 24 views as world -> camera (quat (w, x, y, z), t); the rotation
    [[c, 0, s], [0, 1, 0], [-s, 0, c]] is a turn by yaw about y."""
    return [(np.array([math.cos(0.045 * (i - 11)), 0.0,
                       math.sin(0.045 * (i - 11)), 0.0]),
             np.array([0.22 * (i % 5 - 2), 0.1 * (i % 3 - 1),
                       0.35 * (i % 4)]))
            for i in range(24)]
