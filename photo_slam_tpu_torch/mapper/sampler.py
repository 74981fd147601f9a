"""Keyframe sampling: shuffled ring with times-of-use budgets.

photo_slam_tpu/mapper/sampler.py, copied: Python `random`, so the same seed
gives the same sequence as the JAX package's sampler. Host-side port of the
reference's sampling strategy
(reference: src/gaussian_mapper.cpp:1103-1197):

  * `generateKfidRandomShuffle` -> a reshuffled id ring rebuilt whenever the
    keyframe set changes;
  * `useOneRandomSlidingWindowKeyframe` -> cycle the ring, skipping keyframes
    whose `remaining_times_of_use` is exhausted; when every keyframe is
    exhausted, refill all budgets by +1; decrement on use;
  * `useOneRandomKeyframe` -> plain uniform choice.
"""
from __future__ import annotations

import random
from typing import Optional

from photo_slam_tpu_torch.models.keyframe import Keyframe


class KeyframeSampler:
    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._ring: list[int] = []
        self._pos = 0
        self._known: set[int] = set()
        self.use_counts: dict[int, int] = {}

    def _reshuffle(self, keyframes: dict[int, Keyframe]) -> None:
        self._ring = list(keyframes.keys())
        self._rng.shuffle(self._ring)
        self._pos = 0
        self._known = set(self._ring)

    def sample_sliding_window(self, keyframes: dict[int, Keyframe]
                              ) -> Optional[Keyframe]:
        """Times-of-use ring sampling
        (reference: src/gaussian_mapper.cpp:1126-1173)."""
        if not keyframes:
            return None
        if set(keyframes.keys()) != self._known:
            self._reshuffle(keyframes)

        n = len(self._ring)
        for _ in range(n):
            fid = self._ring[self._pos]
            self._pos = (self._pos + 1) % n
            kf = keyframes.get(fid)
            if kf is not None and kf.remaining_times_of_use > 0:
                kf.remaining_times_of_use -= 1
                self.use_counts[fid] = self.use_counts.get(fid, 0) + 1
                return kf
        # All exhausted: refill everyone by +1 and take the next.
        for kf in keyframes.values():
            kf.remaining_times_of_use += 1
        fid = self._ring[self._pos]
        self._pos = (self._pos + 1) % n
        kf = keyframes[fid]
        kf.remaining_times_of_use -= 1
        self.use_counts[fid] = self.use_counts.get(fid, 0) + 1
        return kf

    def sample_uniform(self, keyframes: dict[int, Keyframe]
                       ) -> Optional[Keyframe]:
        """(reference: src/gaussian_mapper.cpp:1175-1197)."""
        if not keyframes:
            return None
        fid = self._rng.choice(list(keyframes.keys()))
        self.use_counts[fid] = self.use_counts.get(fid, 0) + 1
        return keyframes[fid]
