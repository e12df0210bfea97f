"""Device-resident ring cache of recent keyframes' feature arrays.

The keyframe-rate mapping stages (epipolar triangulation, duplicate fusion,
local BA — reference src/LocalMapping.cc:208-554, src/Optimizer.cc:936-1388)
all consume per-keyframe FEATURE data (xy, ur, octave, angle, desc) that is
immutable once the keyframe exists and that was ALREADY on device when the
frame was tracked.  Downloading it at KF creation and re-uploading it for
every mapping dispatch would cost ~20 host<->device transfers per keyframe.

This cache keeps the last `n_slots` keyframes' feature arrays ON DEVICE as
one stacked pytree, appended at keyframe creation with a single donated
`dynamic_update_slice` program (device->device, zero channel traffic).  The
mapping kernels then gather features by slot index inside their own
programs; only host-mutated metadata (poses after BA, association masks)
travels host->device, packed into one buffer per dispatch.

Slot assignment is round-robin; `slots_of` returns -1 for evicted keyframes
so callers can fall back to a host upload for the (rare) old keyframe that
re-enters a window after a loop closure.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class CacheArrays(NamedTuple):
    """Stacked per-slot feature arrays (device)."""

    xy: jnp.ndarray      # (S, N, 2) f32
    ur: jnp.ndarray      # (S, N) f32
    octave: jnp.ndarray  # (S, N) i32
    angle: jnp.ndarray   # (S, N) f32
    desc: jnp.ndarray    # (S, N, 8) u32
    valid: jnp.ndarray   # (S, N) bool


@jax.jit
def _put(arrs: CacheArrays, slot, xy, ur, octave, angle, desc, valid):
    # NOT donated: a donating dispatch may synchronize with the host; the
    # extra on-device copy of the ~3.6 MB cache is a few MB of device
    # memory traffic per keyframe (kept until measured on the GPU)
    upd = lambda dst, src: jax.lax.dynamic_update_slice(
        dst, src[None], (slot,) + (0,) * src.ndim)
    return CacheArrays(
        xy=upd(arrs.xy, xy), ur=upd(arrs.ur, ur),
        octave=upd(arrs.octave, octave), angle=upd(arrs.angle, angle),
        desc=upd(arrs.desc, desc), valid=upd(arrs.valid, valid))


class KfCache:
    def __init__(self, n_slots: int, n_kp: int):
        self.n_slots = n_slots
        self.n_kp = n_kp
        S, N = n_slots, n_kp
        self.arrays = CacheArrays(
            xy=jnp.zeros((S, N, 2), jnp.float32),
            ur=jnp.full((S, N), -1.0, jnp.float32),
            octave=jnp.zeros((S, N), jnp.int32),
            angle=jnp.zeros((S, N), jnp.float32),
            desc=jnp.zeros((S, N, 8), jnp.uint32),
            valid=jnp.zeros((S, N), bool),
        )
        self._slot_of: dict[int, int] = {}
        self._kf_in: list[int] = [-1] * S
        self._next = 0

    def put(self, kf_id: int, feats) -> int:
        """Append a keyframe's features (device arrays, e.g. fd.feats).
        Re-putting a cached keyframe reuses its slot (a second ring slot
        would leave a stale entry that silently evicts the LIVE mapping
        when the ring wraps)."""
        slot = self._slot_of.get(kf_id)
        if slot is None:
            slot = self._next
            self._next = (self._next + 1) % self.n_slots
            old = self._kf_in[slot]
            if old >= 0:
                self._slot_of.pop(old, None)
        self._kf_in[slot] = kf_id
        self._slot_of[kf_id] = slot
        self.arrays = _put(self.arrays, slot, feats.xy, feats.ur,
                           feats.octave, feats.angle, feats.desc, feats.valid)
        return slot

    def slots_of(self, kf_ids) -> np.ndarray:
        """Slot per keyframe id, -1 when evicted (or never cached)."""
        return np.array([self._slot_of.get(int(k), -1) for k in kf_ids],
                        np.int32)

    def clear(self) -> None:
        self._slot_of.clear()
        self._kf_in = [-1] * self.n_slots
        self._next = 0
