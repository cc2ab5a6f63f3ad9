"""Vectorized rollout-payload validation at the storage edge.

The port's own copy of ``tpu_rl.heal.ingress``, unchanged in behaviour.

``tick_clean`` runs on storage's single-threaded ingest path for every
RolloutBatch frame, so it is hot-path STRICT (see the tools/analysis
manifest): two ``np.isfinite(...).all()`` reductions plus one abs-max
bound, no allocation beyond numpy's internal reduction scratch, no
formatting, no containers.

The guard only *classifies*; the quarantine decision (per-wid strikes on
the ``MembershipTable``) and the drop accounting live in
``LearnerStorage._ingress_admit`` so the byte-exact chaos parity
(injected == poisoned) is enforced at one site.
"""

from __future__ import annotations

import numpy as np


class IngressGuard:
    """Finite/range checks over the obs/rew columns of one frame."""

    __slots__ = ("abs_max", "n_checked", "n_poisoned", "n_quarantined_frames")

    def __init__(self, abs_max: float = 1e6):
        self.abs_max = float(abs_max)
        self.n_checked = 0
        self.n_poisoned = 0
        self.n_quarantined_frames = 0

    def tick_clean(self, payload) -> bool:
        """True iff the frame's obs and rew columns are finite and bounded."""
        self.n_checked += 1
        obs = payload.get("obs")
        rew = payload.get("rew")
        if obs is not None:
            obs = np.asarray(obs)
            if not np.isfinite(obs).all():
                return False
            if np.abs(obs).max(initial=0.0) > self.abs_max:
                return False
        if rew is not None:
            rew = np.asarray(rew)
            if not np.isfinite(rew).all():
                return False
            if np.abs(rew).max(initial=0.0) > self.abs_max:
                return False
        return True
